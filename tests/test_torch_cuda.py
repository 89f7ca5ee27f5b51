"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips (the CUDA kernels have no CPU mode).
"""
import hashlib
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

FP32_TOL = 1e-5  # the same products, fp32 sums in another order


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _device_kernels(fn):
    """``(fn(), the device kernels that one call of fn launches)``, read by
    ``torch.profiler``. ``fn`` (pure) runs once before the window: a
    kernel's first launch in a process loads its library and module, and a
    window around that first launch can come back with the host's events
    but none from the device. A capture with no device event at all is
    taken once more; a second fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return out, kernels
        warnings.warn("torch.profiler recorded no device event; capturing again")
    pytest.fail("torch.profiler recorded no device event in two captures")


def _round_state(rng, k, m, max_count):
    count = rng.integers(0, max_count, size=k).astype(np.float32)
    mean = rng.normal(0, 0.05, k).astype(np.float32)
    m2 = (np.maximum(count - 1, 0) * rng.uniform(0.5, 2.0, k)).astype(np.float32)
    l = (mean[:, None] + rng.standard_normal((k, m))).astype(np.float32)
    valid = rng.uniform(size=(k, m)) < 0.9
    if k > 2:
        valid[1] = False  # an empty batch keeps its state
        l[2] = 0.125  # a constant batch into an empty accumulator: s == 0
        count[2] = mean[2] = m2[2] = 0
    mu0 = rng.normal(0, 0.05, k).astype(np.float32)
    return count, mean, m2, l, valid, mu0


def _df_span_state():
    """32 chains whose df spans 1 .. 1e5 after the merge, with an s == 0
    chain and an exhausted one (``chip_smoke.py``'s phase A case)."""
    k, m, n_total = 32, 100, 100_200
    rng = np.random.default_rng(0)
    prior_n = np.floor(np.logspace(1, 5, k)).astype(np.float32)
    nvalid = np.full(k, m)
    prior_n[:3] = 0
    nvalid[0], nvalid[1] = 2, 3
    prior_n[3] = n_total - m
    mu0 = rng.normal(0, 0.1, k).astype(np.float32)
    mean0 = (mu0 + rng.uniform(0.0, 4.0, k) / np.sqrt(np.maximum(prior_n + nvalid, 1))
             ).astype(np.float32)
    l = (mean0[:, None] + rng.standard_normal((k, m))).astype(np.float32)
    l[2] = 0.25
    valid = np.arange(m)[None, :] < nvalid[:, None]
    m2 = np.maximum(prior_n - 1, 0).astype(np.float32)
    return prior_n, mean0, m2, l, valid, mu0, n_total


# (K, m) of the round op's card cases, the df 1 .. 1e5 state, and chains
# whose deltas equal their mean (s ~ 1e-14, t ~ 1e12, x ~ 1e-21 < 2^-60:
# the kernel's divisions leave the range of its fast form)
_ROUND_CASES = ["K1_m4", "K5_m37", "K32_m100", "K33_m512", "df_1_to_1e5", "near_constant"]


def _round_inputs(case):
    """Numpy inputs of one case: the initial state, (mu0, eps, n_total,
    max_rounds) and three rounds of (l, valid), the later two drawn like
    the first (the near-constant case repeats its one batch)."""
    if case == "df_1_to_1e5":
        count, mean, m2, l, valid, mu0, n_total = _df_span_state()
        rng = np.random.default_rng(10)
        max_rounds = 10_000
    elif case == "near_constant":
        rng = np.random.default_rng(11)
        k, m = 8, 100
        count = rng.integers(100, 5000, size=k).astype(np.float32)
        # multiples of 2^-10: the sums of the batch are exact, delta is 0
        mean = (np.round(rng.normal(0, 0.05, k) * 1024) / 1024).astype(np.float32)
        m2 = ((count - 1) * 1e-24).astype(np.float32)
        mu0 = rng.normal(0, 0.05, k).astype(np.float32)
        l = np.repeat(mean[:, None], m, axis=1)
        valid = np.ones((k, m), bool)
        eps = np.full(k, 0.05, np.float32)
        return (count, mean, m2), (mu0, eps, 12214, 123), [(l, valid)] * 3
    else:
        k, m = (int(v[1:]) for v in case.split("_"))
        rng = np.random.default_rng(k * 1000 + m)
        count, mean, m2, l, valid, mu0 = _round_state(rng, k, m, 5000)
        n_total, max_rounds = 12214, 123
    k, m = l.shape
    batches = [(l, valid)] + [((mean[:, None] + rng.standard_normal((k, m))).astype(np.float32),
                               rng.uniform(size=(k, m)) < 0.9) for _ in range(2)]
    eps = np.full(k, 0.05, np.float32)
    return (count, mean, m2), (mu0, eps, n_total, max_rounds), batches


def _run_rounds(case, dev, round_fn):
    """Run the case's three rounds through ``round_fn`` (``ops.t_test_round``
    with a mode, or any function of its arguments); the state after each."""
    (count, mean, m2), (mu0, eps, n_total, max_rounds), batches = _round_inputs(case)
    k = len(count)
    st = [torch.tensor(a, device=dev) for a in (count, mean, m2)]
    rest = [torch.zeros(k, dtype=torch.int32, device=dev), torch.zeros(k, dtype=torch.bool, device=dev),
            torch.zeros(k, dtype=torch.bool, device=dev), torch.ones(k, device=dev)]
    mu0_t, eps_t = torch.tensor(mu0, device=dev), torch.tensor(eps, device=dev)
    after = []
    for l, valid in batches:
        round_fn(torch.tensor(l, device=dev), torch.tensor(valid, device=dev), *st, mu0_t, eps_t,
                 n_total, max_rounds, *rest)
        after.append([t.clone() for t in st + rest])
    return after


def _digest(after) -> str:
    """sha256 (first 16 hex digits) of every state tensor after every round:
    count, mean, m2, rounds, done, decision, pval."""
    h = hashlib.sha256()
    for state in after:
        for t in state:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_pair_delta_kernel_matches_plain(prec, cuda_device):
    """One chain (full pool and row-index forms) and the gathered ensemble
    round, kernel against plain version on the same card."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, k, m = 12214, 50, 32, 100
    x = torch.randn(n, d, generator=gen, device=cuda_device) / d ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device=cuda_device) < 0.5, 1.0, -1.0)
    if prec == "bf16":
        x = x.to(torch.bfloat16)
    w = torch.randn(k, d, generator=gen, device=cuda_device)
    wp = w + 0.05 * torch.randn(k, d, generator=gen, device=cuda_device)
    idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
    ops.reset_launches()
    for run in (lambda mode: ops.logit_delta(x, y, w[0], wp[0], mode=mode, precision=prec),
                lambda mode: ops.logit_delta(x, y, w[0], wp[0], idx=idx[0], mode=mode,
                                             precision=prec),
                lambda mode: ops.gather_and_delta(x, y, idx, w, wp, mode=mode, precision=prec)):
        torch.testing.assert_close(run("always"), run("never"), rtol=FP32_TOL, atol=FP32_TOL)
    assert ops.launches["logit_delta"] == 2 and ops.launches["batched_logit_delta"] == 1


def _pool(gen, dev, n, d, dtype, offset=0):
    """An (n, d) pool and its labels; ``offset`` elements into a larger
    buffer, so that rows start off the 16-byte boundary."""
    x = torch.empty(n * d + offset, dtype=dtype, device=dev)[offset:].view(n, d)
    x.copy_(torch.randn(n, d, generator=gen, device=dev) / d ** 0.5)
    y = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [1, 2, 3, 50, 64, 129])
def test_pair_delta_kernel_shapes(d, prec, cuda_device):
    """Every lane width (one row per thread at D <= 2 up to 32 lanes and
    several vectors a lane at D = 129), vector widths from 2 to 16 bytes
    (bf16 rows of odd D take 2-byte loads), ragged m and K = 1, 32, 33:
    gathered, pre-gathered and one-chain forms against the plain version,
    also on a pool whose rows start 4 (fp32) or 2 (bf16) bytes off the
    16-byte boundary."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    n = 3001
    for offset in (0, 1):
        x, y = _pool(gen, cuda_device, n, d, dtype, offset)
        for k in (1, 32, 33):
            w = torch.randn(k, d, generator=gen, device=cuda_device)
            wp = w + 0.05 * torch.randn(k, d, generator=gen, device=cuda_device)
            for m in (1, 7, 100, 1000):
                idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device,
                                    dtype=torch.int32)
                xg, yg = x[idx.long()].contiguous(), y[idx.long()].contiguous()
                runs = [lambda mode: ops.gather_and_delta(x, y, idx, w, wp, mode=mode,
                                                          precision=prec),
                        lambda mode: ops.batched_logit_delta(xg, yg, w, wp, mode=mode,
                                                             precision=prec)]
                if k == 1:
                    runs.append(lambda mode: ops.logit_delta(x, y, w[0], wp[0], idx=idx[0],
                                                             mode=mode, precision=prec))
                for run in runs:
                    got, want = run("always"), run("never")
                    assert got.shape == want.shape
                    torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL,
                                               msg=f"D={d} {prec} offset={offset} K={k} m={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [2, 50])
def test_pair_delta_range_form(d, prec, cuda_device):
    """The exact pass's contiguous form: runs of a pool of N = 10007 rows
    (off every tile), starting off the 16-byte boundary, bit-equal to the
    index-tensor form on the same rows (below the kernel's long-pass length
    both forms give a row the same lanes and reduction) and within 1e-5 of
    the plain version; an empty run gives an empty result."""
    gen = torch.Generator(device=cuda_device).manual_seed(100 + d)
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    n = 10007
    x, y = _pool(gen, cuda_device, n, d, dtype)
    w = torch.randn(d, generator=gen, device=cuda_device)
    wp = w + 0.05 * torch.randn(d, generator=gen, device=cuda_device)
    for start, stop in [(0, n), (3, n), (1001, 5000), (n - 1, n), (5, 6), (77, 77 + 1023)]:
        ops.reset_launches()
        got = ops.logit_delta(x, y, w, wp, idx=range(start, stop), precision=prec)
        assert ops.launches["logit_delta"] == 1
        by_index = ops.logit_delta(x, y, w, wp, precision=prec,
                                   idx=torch.arange(start, stop, dtype=torch.int32,
                                                    device=cuda_device))
        want = ops.logit_delta(x, y, w, wp, idx=range(start, stop), precision=prec, mode="never")
        assert torch.equal(got, by_index), (start, stop)
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    assert ops.logit_delta(x, y, w, wp, idx=range(9, 9), precision=prec).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 50])
def test_pair_delta_full_pass_at_1e6(d, cuda_device):
    """The full pass at N = 1e6 (phase D's D = 2; D = 50 at the Sec. 4.1
    width), as a range and over the whole pool."""
    gen = torch.Generator(device=cuda_device).manual_seed(200 + d)
    n = 1_000_000
    x, y = _pool(gen, cuda_device, n, d, torch.float32)
    w = torch.randn(d, generator=gen, device=cuda_device)
    wp = w + 0.05 * torch.randn(d, generator=gen, device=cuda_device)
    want = ops.logit_delta(x, y, w, wp, mode="never")
    for idx in (None, range(0, n)):
        torch.testing.assert_close(ops.logit_delta(x, y, w, wp, idx=idx, mode="always"), want,
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["fp32", "bf16"])
def test_bf16_logit_call_is_one_launch(rows, cuda_device):
    """precision="bf16" rounds the pair (and fp32 rows) in the kernel: each
    form is one launch on the card, with no cast in front of it, and within
    1e-5 of the plain route, which rounds copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n, d, k, m = 12214, 50, 32, 100
    x, y = _pool(gen, cuda_device, n, d, torch.bfloat16 if rows == "bf16" else torch.float32)
    w = 2.0 * torch.randn(k, d, generator=gen, device=cuda_device)
    wp = w + 0.05 * torch.randn(k, d, generator=gen, device=cuda_device)
    idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
    xg, yg = x[idx.long()].contiguous(), y[idx.long()].contiguous()
    forms = [lambda mode: ops.gather_and_delta(x, y, idx, w, wp, mode=mode, precision="bf16"),
             lambda mode: ops.batched_logit_delta(xg, yg, w, wp, mode=mode, precision="bf16"),
             lambda mode: ops.logit_delta(x, y, w[0], wp[0], idx=idx[0], mode=mode,
                                          precision="bf16"),
             lambda mode: ops.logit_delta(x, y, w[0], wp[0], idx=range(5, n), mode=mode,
                                          precision="bf16")]
    for run in forms:
        want = run("never")
        torch.cuda.synchronize()
        got, kernels = _device_kernels(lambda: run("always"))
        assert len(kernels) == 1 and "pair_delta_kernel" in kernels[0], kernels
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _ROUND_CASES)
def test_round_kernel_matches_plain(case, cuda_device):
    """The round op over three rounds: counts, rounds, done flags and
    decisions identical; mean, m2 and p-value within 1e-4 relative (the
    merge sums in another order). m = 4, 37 and 512 leave lanes idle or
    give a lane several values per partial; K = 1, 5 and 33 leave warps of
    the last block without a chain."""
    ops.reset_launches()
    got, want = (_run_rounds(case, cuda_device, lambda *a, mode=mode: ops.t_test_round(*a, mode=mode))
                 for mode in ("always", "never"))
    assert ops.launches["t_test_round"] == 3
    for g, w in zip(got, want):
        for i in (0, 3, 4, 5):  # count, rounds, done, decision
            assert torch.equal(g[i], w[i])
        for i in (1, 2, 6):  # mean, m2, pval
            torch.testing.assert_close(g[i], w[i], rtol=1e-4, atol=1e-7)


# _digest of each case's outputs from the block-per-chain form of the round
# kernel (128 threads a chain, one thread on the p-value), which the
# warp-per-chain form must reproduce bit for bit
_ROUND_DIGESTS = {
    "K1_m4": "0e0cecfdac8629f0",
    "K5_m37": "61e7fd8a92d8549d",
    "K32_m100": "969322a10997d85d",
    "K33_m512": "76e281a9ba7e6b8d",
    "df_1_to_1e5": "01c463f292f535ce",
    "near_constant": "71e7d08ec4d958d6",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", _ROUND_CASES)
def test_round_kernel_reproduces_block_kernel_bits(case, cuda_device):
    """Every output of every round equals, bit for bit, what the earlier
    block-per-chain kernel gave on the same inputs: the same float32
    operations in the same order, the sums in that block's order."""
    after = _run_rounds(case, cuda_device, lambda *a: ops.t_test_round(*a, mode="always"))
    assert _digest(after) == _ROUND_DIGESTS[case]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_ar1_delta_kernel_matches_plain(prec, cuda_device):
    """The AR(1) pair delta on gathered sections, on a shared pool and on
    per-chain pools: kernel against plain version, the same float32
    operations in the same order (tolerance: a few ulps of the two terms)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    k, m, n = 32, 100, 1000
    pools = [0.3 * torch.randn(k, n, generator=gen, device=cuda_device) for _ in range(2)]
    if prec == "bf16":
        pools = [p.to(torch.bfloat16) for p in pools]
    phi = 0.9 + 0.05 * torch.rand(k, generator=gen, device=cuda_device)
    s2 = 0.01 + 0.01 * torch.rand(k, generator=gen, device=cuda_device)
    par = (phi, s2, phi + 0.01, s2 * 1.1)
    idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
    ops.reset_launches()
    for run in (lambda mode: ops.gather_ar1_delta(pools[0][0], pools[1][0], idx, *par, mode=mode),
                lambda mode: ops.gather_ar1_delta(*pools, idx, *par, mode=mode),
                lambda mode: ops.batched_gaussian_ar1_delta(pools[0][:, :m].contiguous(),
                                                            pools[1][:, :m].contiguous(), *par,
                                                            mode=mode)):
        torch.testing.assert_close(run("always"), run("never"), rtol=1e-5, atol=1e-4)
    assert ops.launches["gaussian_ar1_delta"] == 3


# The AR(1) delta's card cases: every (K, m) of K in {1, 32, 33} and m in
# {1, 100, 129}, on shared (N,) and per-chain (K, N) pools and on
# pre-gathered (K, m) sections, each also 4 (fp32) or 2 (bf16) bytes off
# the 16-byte boundary; fp32 pools, bf16 pools, and fp32 pools at precision
# bf16 (rounded in the kernel)
_AR1_PRECS = ["fp32", "bf16", "fp32 pools, precision bf16"]


def _offset(a: np.ndarray, dtype, dev, offset: int) -> torch.Tensor:
    """``a`` on the card as ``dtype``, ``offset`` elements into a buffer."""
    buf = torch.empty(a.size + offset, dtype=dtype, device=dev)[offset:]
    buf.copy_(torch.tensor(a.ravel()))
    return buf.view(a.shape)


def _ar1_calls(prec, dev):
    """(label, call(mode)) for every card case of one precision; the inputs
    come from numpy, so every run sees the same numbers."""
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    precision = "fp32" if prec == "fp32" else "bf16"
    n = 1000
    calls = []
    for k in (1, 32, 33):
        rng = np.random.default_rng(k)
        pools = [(0.3 * rng.standard_normal((k, n))).astype(np.float32) for _ in range(2)]
        phi = rng.uniform(0.85, 0.99, k).astype(np.float32)
        s2 = rng.uniform(0.005, 0.02, k).astype(np.float32)
        par = [torch.tensor(v, device=dev) for v in (phi, s2, phi + 0.01, s2 * 1.1)]
        for m in (1, 100, 129):
            idx = torch.tensor(rng.integers(0, n, (k, m)), dtype=torch.int32, device=dev)
            for offset in (0, 1):
                per_chain = [_offset(a, dtype, dev, offset) for a in pools]
                shared = [_offset(a[0], dtype, dev, offset) for a in pools]
                sections = [_offset(a[:, :m], dtype, dev, offset) for a in pools]
                where = f"K={k} m={m} offset={offset}"
                calls += [
                    (f"shared {where}", lambda mode, x=shared, i=idx, par=par: ops.gather_ar1_delta(
                        *x, i, *par, mode=mode, precision=precision)),
                    (f"per-chain {where}", lambda mode, x=per_chain, i=idx, par=par:
                     ops.gather_ar1_delta(*x, i, *par, mode=mode, precision=precision)),
                    (f"pre-gathered {where}", lambda mode, x=sections, par=par:
                     ops.batched_gaussian_ar1_delta(*x, *par, mode=mode, precision=precision))]
    return calls


def _outputs_digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ar1_digest(prec, dev) -> str:
    """sha256 (first 16 hex digits) of the kernel's outputs over every case
    of ``_ar1_calls``."""
    return _outputs_digest([call("always") for _, call in _ar1_calls(prec, dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("prec", _AR1_PRECS)
def test_ar1_delta_kernel_shapes(prec, cuda_device):
    """Every card case against its plain version (the tolerance of
    test_ar1_delta_kernel_matches_plain), one launch each."""
    for label, call in _ar1_calls(prec, cuda_device):
        ops.reset_launches()
        got = call("always")
        assert ops.launches["gaussian_ar1_delta"] == 1, label
        torch.testing.assert_close(got, call("never"), rtol=1e-5, atol=1e-4, msg=label)


# _ar1_digest of each precision from the thread-per-section kernel (256
# threads a block, the pools cast to bf16 in front of it for precision bf16),
# which every form of the warp-a-block kernel must reproduce bit for bit
_AR1_DIGESTS = {
    "fp32": "120014f6e0723192",
    "bf16": "14cac01f2856a69f",
    "fp32 pools, precision bf16": "14cac01f2856a69f",
}


@pytest.mark.cuda
@pytest.mark.parametrize("prec", _AR1_PRECS)
def test_ar1_delta_reproduces_thread_kernel_bits(prec, cuda_device):
    """Every output equals, bit for bit, what the earlier thread-per-section
    kernel gave on the same inputs: the same float32 operations in the same
    order, and the bf16 rounding of x.to(torch.bfloat16)."""
    assert _ar1_digest(prec, cuda_device) == _AR1_DIGESTS[prec]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", _AR1_PRECS)
def test_ar1_delta_range_form(prec, cuda_device):
    """The exact pass's contiguous form on shared pools of N = 10007
    sections (off every group of 16 bytes), also 4 or 2 bytes off the
    16-byte boundary and with xt and xp at different offsets from it:
    bit-equal to the index form on the same sections, within tolerance of
    the plain version, one launch a call; an empty run gives (1, 0)."""
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    precision = "fp32" if prec == "fp32" else "bf16"
    rng = np.random.default_rng(17)
    n = 10007
    a, b = ((0.3 * rng.standard_normal(n)).astype(np.float32) for _ in range(2))
    par = [torch.tensor([v], dtype=torch.float32, device=cuda_device)
           for v in (0.95, 0.01, 0.96, 0.011)]
    for off_t, off_p in ((0, 0), (1, 1), (0, 1), (3, 2)):
        xt, xp = _offset(a, dtype, cuda_device, off_t), _offset(b, dtype, cuda_device, off_p)
        for start, stop in [(0, n), (3, n), (1001, 5000), (n - 1, n), (5, 6), (77, 77 + 1023)]:
            run = lambda idx, mode="always": ops.gather_ar1_delta(xt, xp, idx, *par, mode=mode,
                                                                  precision=precision)
            ops.reset_launches()
            got = run(range(start, stop))
            assert ops.launches["gaussian_ar1_delta"] == 1 and got.shape == (1, stop - start)
            by_index = run(torch.arange(start, stop, dtype=torch.int32, device=cuda_device)[None])
            assert torch.equal(got, by_index), (off_t, off_p, start, stop)
            torch.testing.assert_close(got, run(range(start, stop), "never"), rtol=1e-5,
                                       atol=1e-4)
        assert run(range(9, 9)).shape == (1, 0)


@pytest.mark.cuda
def test_bf16_ar1_call_is_one_launch(cuda_device):
    """precision="bf16" on fp32 pools rounds them in the kernel: each form
    is one launch on the card, with no cast in front of it, and its bits are
    the kernel's on pools cast with x.to(torch.bfloat16)."""
    rng = np.random.default_rng(5)
    k, m, n = 32, 100, 1000
    pools = [torch.tensor((0.3 * rng.standard_normal((k, n))).astype(np.float32),
                          device=cuda_device) for _ in range(2)]
    idx = torch.tensor(rng.integers(0, n, (k, m)), dtype=torch.int32, device=cuda_device)
    par = [torch.tensor(v, device=cuda_device) for v in
           (rng.uniform(0.85, 0.99, k).astype(np.float32),
            rng.uniform(0.005, 0.02, k).astype(np.float32))]
    par += [par[0] + 0.01, par[1] * 1.1]
    # x: the (K, N) pools and their first m columns as (K, m) sections
    forms = [lambda x, p: ops.gather_ar1_delta(*x[:2], idx, *par, precision=p),
             lambda x, p: ops.gather_ar1_delta(x[0][0], x[1][0], idx, *par, precision=p),
             lambda x, p: ops.batched_gaussian_ar1_delta(*x[2:], *par, precision=p),
             lambda x, p: ops.gather_ar1_delta(x[0][0], x[1][0], range(7, n),
                                               *(v[:1] for v in par), precision=p)]
    pools += [x[:, :m].contiguous() for x in pools]
    cast = [x.to(torch.bfloat16) for x in pools]
    for run in forms:
        want = run(cast, "fp32")
        torch.cuda.synchronize()
        got, kernels = _device_kernels(lambda: run(pools, "bf16"))
        assert len(kernels) == 1 and "ar1_" in kernels[0], kernels
        assert torch.equal(got, want)


# name: (K, capacity, size, pos, m, uniforms, inactive share, rounds). A
# number as the uniforms gives every step that uniform; chain 3, where there
# is one, has a pool 5% smaller than the others' (pos clamped to it).
_FY_CASES = {
    "rounds_to_exhaustion": (32, 1000, 1000, 0, 100, None, 0.2, 12),
    "duplicate_targets": (4, 1000, 1000, 0, 100, 1.0 - 2.0 ** -30, 0.0, 1),
    "target_in_window_ahead": (4, 1000, 1000, 0, 100, 0.05, 0.0, 1),
    "pos_plus_m_past_capacity": (4, 1000, 1000, 950, 100, None, 0.0, 2),
    "exhausted_pool": (4, 1000, 1000, 1000, 100, None, 0.0, 1),
    "size_below_capacity": (4, 1000, 600, 550, 100, None, 0.0, 2),
    "m_above_size": (4, 64, 40, 0, 100, None, 0.0, 1),
    "K1": (1, 1000, 1000, 0, 100, None, 0.0, 3),
    "K5": (5, 1000, 1000, 0, 100, None, 0.2, 3),
    "K33": (33, 1000, 1000, 0, 100, None, 0.2, 3),
    "K1_N1e5": (1, 100_000, 100_000, 0, 100, None, 0.0, 3),
    "m300_three_chunks": (3, 1000, 1000, 0, 300, None, 0.0, 4),
}


def _swap_pairs(u, pos, size, m, cap):
    """Host copy of every step's (p, j) for all-active chains."""
    p = np.minimum(pos[:, None] + np.arange(m), cap - 1)
    span = np.maximum(size[:, None] - p, 1)
    return p, np.minimum(p + np.minimum((u * span).astype(np.int64), span - 1), cap - 1)


def _fy_rounds(case, dev, draw):
    """Run a ``_FY_CASES`` case through ``draw(u, buf, pos, size, m, active)``
    from its permuted buffers, round after round; returns the outputs of
    every round and the final buffers."""
    k, cap, size, pos, m, uni, inactive, rounds = _FY_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(list(_FY_CASES).index(case))
    sizes = np.full(k, size, np.int32)
    if k > 3:
        sizes[3] = size * 19 // 20
    size_t = torch.tensor(sizes, device=dev)
    buf = torch.argsort(torch.rand(k, cap, generator=gen, device=dev), dim=1).int()
    pos_t = torch.tensor(np.minimum(pos, sizes), dtype=torch.int32, device=dev)
    outs = []
    for _ in range(rounds):
        u = torch.rand((k, m), generator=gen, dtype=torch.float64, device=dev)
        if uni is not None:
            u.fill_(uni)
        active = torch.rand(k, generator=gen, device=dev) >= inactive
        out = draw(u, buf, pos_t, size_t, m, active)
        outs.append(out)
        pos_t = out[2]
    return outs, buf


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FY_CASES))
def test_fy_draw_kernel_matches_plain(case, cuda_device):
    """Identical indices, valid flags, positions and buffers, round after
    round: the same swaps from the same float64 uniforms, from permuted
    buffers, with some chains inactive where the case says so."""
    k, cap, size, pos, m, uni, inactive, rounds = _FY_CASES[case]
    if case in ("duplicate_targets", "target_in_window_ahead"):
        u = np.full((k, m), uni)
        p, j = _swap_pairs(u, np.zeros(k, np.int64), np.full(k, size), m, cap)
        moved = j[0][j[0] != p[0]]
        if case == "duplicate_targets":
            assert len(np.unique(moved)) < len(moved)
        else:
            assert np.any((j[0] > p[0]) & (j[0] < m))
    ops.reset_launches()
    got, buf_k = _fy_rounds(case, cuda_device, lambda *a: ops.fy_draw(*a, mode="always"))
    want, buf_p = _fy_rounds(case, cuda_device, lambda *a: ops.fy_draw(*a, mode="never"))
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(buf_k, buf_p)
    assert ops.launches["fy_draw"] == rounds
    ref = torch.arange(cap, dtype=torch.int32, device=cuda_device)
    assert all(torch.equal(row.sort().values, ref) for row in buf_k)  # still permutations


def _fy_digest(dev) -> str:
    """sha256 (first 16 hex digits) of the kernel's outputs and final
    buffers over every ``_FY_CASES`` case, without ``m_eff``."""
    outs = []
    for case in _FY_CASES:
        rounds, buf = _fy_rounds(case, dev, lambda *a: ops.fy_draw(*a, mode="always"))
        outs += [t for r in rounds for t in r] + [buf]
    return _outputs_digest(outs)


# _fy_digest from the kernel before the per-chain m_eff existed, which a null
# m_eff must reproduce bit for bit
_FY_DIGEST = "ed8a1accdad73ed1"


@pytest.mark.cuda
def test_fy_draw_without_m_eff_reproduces_earlier_kernel_bits(cuda_device):
    assert _fy_digest(cuda_device) == _FY_DIGEST


# name: (K, capacity = size, m_max, rounds, inactive share). Each chain's
# m_eff is drawn in [0, m_max] with chain 0 at 0 and chain 1 at m_max; the
# pools of N = 1000 run out partway, N = 12214 is the BayesLR pool.
_FY_BOUNDED_CASES = {
    "K1_m100": (1, 12214, 100, 4, 0.0),
    "K32_m100": (32, 12214, 100, 4, 0.2),
    "K32_m400": (32, 12214, 400, 4, 0.2),
    "K33_m400": (33, 12214, 400, 4, 0.2),
    "K32_m400_runs_out": (32, 1000, 400, 6, 0.2),
    "K33_m100_runs_out": (33, 1000, 100, 14, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FY_BOUNDED_CASES))
def test_fy_draw_bounded_kernel_matches_plain(case, cuda_device):
    """The per-chain m_eff: identical indices, valid flags, positions and
    buffers, round after round, with ragged m_eff (0 and m_max among them)
    and inactive chains; valid lanes never repeat an index within a
    transition; m_eff = m_max everywhere equals no m_eff."""
    k, n, m, rounds, inactive = _FY_BOUNDED_CASES[case]
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(list(_FY_BOUNDED_CASES).index(case) + 100)
    m_eff = torch.randint(0, m + 1, (k,), generator=gen, device=dev, dtype=torch.int32)
    m_eff[0] = 0
    if k > 1:
        m_eff[1] = m
    size = torch.full((k,), n, dtype=torch.int32, device=dev)
    start = torch.argsort(torch.rand(k, n, generator=gen, device=dev), dim=1).int()
    bufs = [start.clone(), start.clone(), start.clone(), start.clone()]
    pos = [torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(4)]
    seen = [set() for _ in range(k)]
    ops.reset_launches()
    for _ in range(rounds):
        u = torch.rand((k, m), generator=gen, dtype=torch.float64, device=dev)
        active = torch.rand(k, generator=gen, device=dev) >= inactive
        outs = [ops.fy_draw(u, bufs[i], pos[i], size, m, active, mode=mode, m_eff=me)
                for i, (mode, me) in enumerate((("always", m_eff), ("never", m_eff),
                                                ("always", torch.full_like(m_eff, m)),
                                                ("always", None)))]
        for a, b in zip(outs[0], outs[1]):
            assert torch.equal(a, b)
        for a, b in zip(outs[2], outs[3]):
            assert torch.equal(a, b)
        assert torch.equal(bufs[0], bufs[1]) and torch.equal(bufs[2], bufs[3])
        out, valid, new_pos = (t.cpu().numpy() for t in outs[0])
        act, me, p0 = active.cpu().numpy(), m_eff.cpu().numpy(), pos[0].cpu().numpy()
        for c in range(k):
            assert valid[c].sum() == min(me[c], n - p0[c]) and not valid[c, me[c]:].any()
            assert new_pos[c] == (min(p0[c] + me[c], n) if act[c] else p0[c])
            if act[c]:
                drawn = set(out[c][valid[c]].tolist())
                assert not drawn & seen[c]
                seen[c] |= drawn
        pos = [o[2] for o in outs]
    assert ops.launches["fy_draw"] == 3 * rounds
    ref = torch.arange(n, dtype=torch.int32, device=dev)
    assert all(torch.equal(row.sort().values, ref) for row in bufs[0])  # still permutations


@pytest.mark.cuda
def test_pgibbs_kernel_matches_plain(cuda_device):
    """The sweep from the same random numbers: paths equal except where a
    uniform lies within float32 rounding of a CDF boundary (the softmax sum
    and the scan add in another order); at most 1% of the paths differ."""
    from repro_torch.kernels.pgibbs import draw_sweep_randomness

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k, s, t, p = 32, 200, 5, 25
    obs = torch.exp(0.5 * 0.3 * torch.randn(s, t, generator=gen, device=cuda_device)) \
        * torch.randn(s, t, generator=gen, device=cuda_device)
    h = 0.3 * torch.randn(k, s, t, generator=gen, device=cuda_device)
    phi = torch.full((k,), 0.95, device=cuda_device)
    s2 = torch.full((k,), 0.01, device=cuda_device)
    rand = draw_sweep_randomness(gen, k, s, t, p, cuda_device)
    ops.reset_launches()
    got = ops.pgibbs_sweep(*rand, obs, h, phi, s2, mode="always")
    want = ops.pgibbs_sweep(*rand, obs, h, phi, s2, mode="never")
    same = (got == want).all(-1)
    assert float(same.float().mean()) >= 0.99 and ops.launches["pgibbs_sweep"] == 1
    assert bool(torch.isfinite(got).all())


# The sweep's card cases: P particles a series in {1, 16, 25, 32, 33, 256}
# (one or several series a warp, one or several particles a lane), each at
# a Latin square of (K, S, T) over K in {1, 32, 33}, S in {1, 200, 201} and
# T in {1, 5, 40} (every pair of sizes meets once) and at the main path's
# K = 32, S = 200, T = 5
_SWEEP_PARTICLES = [1, 16, 25, 32, 33, 256]
_SWEEP_SHAPES = [(k, s, (1, 5, 40)[(i + j) % 3]) for i, k in enumerate((1, 32, 33))
                 for j, s in enumerate((1, 200, 201))] + [(32, 200, 5)]


def _sweep_inputs(k, s, t, p, dev):
    """obs, h, phi, s2 and the sweep's randomness from numpy."""
    rng = np.random.default_rng([k, s, t, p])
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    obs = np.exp(0.15 * rng.standard_normal((s, t))) * rng.standard_normal((s, t))
    h = 0.3 * rng.standard_normal((k, s, t))
    phi, s2 = rng.uniform(0.85, 0.99, k), rng.uniform(0.005, 0.03, k)
    noise = rng.standard_normal((t, k, s, p), dtype=np.float32)
    u = rng.random((t, k, s, p), dtype=np.float32)
    u_pick = rng.random((k, s), dtype=np.float32)
    return [f32(a) for a in (noise, u, u_pick, obs, h, phi, s2)]


def _sweep_digest(p, dev) -> str:
    """sha256 (first 16 hex digits) of the kernel's paths at every shape of
    ``_SWEEP_SHAPES`` for P particles."""
    outs = []
    for (k, s, t) in _SWEEP_SHAPES:
        outs.append(ops.pgibbs_sweep(*_sweep_inputs(k, s, t, p, dev), mode="always"))
    return _outputs_digest(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("p", _SWEEP_PARTICLES)
def test_pgibbs_kernel_shapes(p, cuda_device):
    """Every shape against the plain version (at most 1% of the paths
    differ, each within float32 rounding of a CDF boundary), one launch
    each; with one particle the retained path comes back unchanged."""
    for (k, s, t) in _SWEEP_SHAPES:
        args = _sweep_inputs(k, s, t, p, cuda_device)
        ops.reset_launches()
        got = ops.pgibbs_sweep(*args, mode="always")
        assert ops.launches["pgibbs_sweep"] == 1
        want = ops.pgibbs_sweep(*args, mode="never")
        frac = 1.0 - float((got == want).all(-1).float().mean())
        assert bool(torch.isfinite(got).all()) and frac <= 0.01, (k, s, t, frac)
        if p == 1:
            assert torch.equal(got, args[4]), (k, s, t)


# _sweep_digest of each P from the warp-per-series kernel (eight series a
# block, global loads inside the step loop, one full-warp tree per series),
# which the new kernel must reproduce bit for bit
_SWEEP_DIGESTS = {1: "0c2fb6a33cdbc4dd", 16: "588c59627aa2c8d3", 25: "fef0ce4eb88a2031",
                  32: "d6a65edebc73028e", 33: "4ff1b701d083822d", 256: "9004acd1a1dd61dc"}


@pytest.mark.cuda
@pytest.mark.parametrize("p", _SWEEP_PARTICLES)
def test_pgibbs_kernel_reproduces_warp_kernel_bits(p, cuda_device):
    """Every path equals, bit for bit, what the earlier warp-per-series
    kernel gave from the same numbers: the weights, max, sum, division and
    scan are its float32 operations in its order."""
    assert _sweep_digest(p, cuda_device) == _SWEEP_DIGESTS[p]


def test_cuda_dispatch_refuses_cpu_tensors():
    """The other side of the device rule, checkable anywhere: `always` on
    CPU tensors raises instead of running the plain version."""
    x = torch.zeros(4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.logit_delta(x, torch.ones(4), torch.zeros(3), torch.zeros(3), mode="always")
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.fy_draw(torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, 5, dtype=torch.int32),
                    z, z + 5, 3, mode="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.pgibbs_sweep(torch.zeros(4, 1, 2, 3), torch.zeros(4, 1, 2, 3), torch.zeros(1, 2),
                                 torch.zeros(2, 4), torch.zeros(1, 2, 4), torch.ones(1),
                                 torch.ones(1), mode="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gather_ar1_delta(torch.zeros(5), torch.zeros(5), torch.zeros(1, 3, dtype=torch.int32),
                             0.9, 0.1, 0.9, 0.1, mode="always")


def _ce_inputs(gen, dev, k, t, d, v, scale=0.5, per_chain=False, dtype=torch.float32):
    h = scale * torch.randn(k, t, d, generator=gen, device=dev)
    table = scale * torch.randn((k, v, d) if per_chain else (v, d), generator=gen, device=dev)
    targets = torch.randint(0, v, (k, t), generator=gen, device=dev, dtype=torch.int32)
    return h.to(dtype), table.to(dtype), targets


def _ce_tol(want, v):
    """1e-4 of log V, or of the largest |per-token value| where extreme
    logits make those large (the JAX package's rtol at extreme logits): fp32
    sums of the same products in another order (the kernel's tiles against
    the plain version's matmul); bf16 operands are rounded alike on both
    sides."""
    return 1e-4 * max(float(np.log(v)), float(want.abs().max()))


# h and table dtypes by route: "fp32" (6 bf16 products), "bf16" (1),
# "bf16 h" (bf16 h, fp32 table: 3, the path's), "bf16 table" (fp32 h: 3) and
# "round" (fp32 operands, precision="bf16": 1)
_CE_DTYPES = {"fp32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
              "bf16 h": (torch.bfloat16, torch.float32),
              "bf16 table": (torch.float32, torch.bfloat16), "round": (torch.float32, torch.float32)}


def _offset_copy(table):
    """The same values 4 bytes past a 16-byte boundary: no TMA map, so the
    kernel's plain-load route."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype, device=table.device)
    out = flat[1:].view(table.shape)
    out.copy_(table)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(_CE_DTYPES))
@pytest.mark.parametrize("t,d,v,scale,layout", [
    (8, 16, 64, 0.5, "contiguous"),  # the smallest tile: layouts and descriptors first
    (37, 16, 129, 0.5, "contiguous"), (100, 48, 300, 0.5, "contiguous"),
    (5, 13, 1000, 0.5, "contiguous"), (16, 8, 64, 30.0, "contiguous"),
    (1, 64, 300, 0.5, "contiguous"), (300, 64, 1000, 0.5, "contiguous"),
    (100, 64, 300, 0.5, "offset")])
def test_fused_ce_kernel_matches_plain(t, d, v, scale, layout, prec, cuda_device):
    """One chain on ragged shapes (T, V off the tiles; m = 1 and m = 300
    across the 104-token tile; D = 13 and a table 4 bytes off its alignment
    take the plain loads) and at extreme logits (30x scale), for every dtype
    route of the tensor-core products."""
    gen = torch.Generator(device=cuda_device).manual_seed(t * 7 + d)
    h_dtype, tab_dtype = _CE_DTYPES[prec]
    h, table, targets = _ce_inputs(gen, cuda_device, 1, t, d, v, scale)
    h, table = h.to(h_dtype), table.to(tab_dtype)
    if layout == "offset":
        table = _offset_copy(table)
    precision = "bf16" if prec == "round" else "auto"
    ops.reset_launches()
    got = ops.fused_ce(h[0], table, targets[0], mode="always", precision=precision)
    want = ops.fused_ce(h[0], table, targets[0], mode="never", precision=precision)
    assert got.shape == (t,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=_ce_tol(want, v))
    assert ops.launches["fused_ce"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("per_chain", [False, True])
def test_batched_and_gather_fused_ce_match_plain(per_chain, cuda_device):
    """K chains with a shared or per-chain table, pre-gathered rows and rows
    read through idx from a shared pool; each chain's row equals the
    single-chain kernel on its slice; precision="bf16" rounds fp32 operands
    in the kernel as the plain route's bf16 copy does."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k, t, d, v, n = 3, 19, 64, 1000, 500
    h, table, targets = _ce_inputs(gen, cuda_device, k, t, d, v, per_chain=per_chain)
    ops.reset_launches()
    got = ops.batched_fused_ce(h, table, targets, mode="always")
    want = ops.batched_fused_ce(h, table, targets, mode="never")
    tol = _ce_tol(want, v)
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    for c in range(k):
        tab_c = table[c] if per_chain else table
        torch.testing.assert_close(got[c], ops.fused_ce(h[c], tab_c, targets[c], mode="always"),
                                   rtol=0, atol=tol)
    pool = torch.randn(n, d, generator=gen, device=cuda_device) * 0.5
    pool_t = torch.randint(0, v, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
    idx = torch.randint(0, n, (k, 33), generator=gen, device=cuda_device, dtype=torch.int32)
    for prec in ("fp32", "bf16"):
        run = lambda mode: ops.gather_fused_ce(pool, pool_t, idx, table, mode=mode, precision=prec)
        torch.testing.assert_close(run("always"), run("never"), rtol=0, atol=tol)
    assert ops.launches["batched_fused_ce"] == 3 and ops.launches["fused_ce"] == k


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_fused_ce_kernel_at_chatglm3_width(k, cuda_device):
    """The ce family's round at chatglm3-6b's width: m=100 bf16 rows of a
    pool against fp32 (V, D) tables, one chain through idx (V = 65024) and
    K=8 per-chain tables through the gather form with V = 64987, off the
    128-row tile. Chain c's table is 0.1 c + small noise (logits ~6 c apart
    from chain to chain, while the tolerance stays that of fp32 sums), so a
    tile that read the next chain's rows past V would show."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    n, d, m = 2000, 4096, 100
    v = 65024 if k == 1 else 65024 - 37
    pool = torch.randn(n, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    pool_t = torch.randint(0, v, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
    ops.reset_launches()
    if k == 1:
        table = 0.02 * torch.randn(v, d, generator=gen, device=cuda_device)
        idx = torch.randint(0, n, (m,), generator=gen, device=cuda_device, dtype=torch.int32)
        run = lambda mode: ops.fused_ce(pool, table, pool_t, idx=idx, mode=mode)
    else:
        table = 0.02 * torch.randn(k, v, d, generator=gen, device=cuda_device)
        table += 0.1 * torch.arange(k, device=cuda_device, dtype=torch.float32)[:, None, None]
        idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
        run = lambda mode: ops.gather_fused_ce(pool, pool_t, idx, table, mode=mode)
    got, want = run("always"), run("never")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(np.log(v)))
    assert ops.launches["fused_ce" if k == 1 else "batched_fused_ce"] == 1


# ---------------------------------------------------------------------------
# The joint DP mixture: the collapsed Gibbs sweep, the round op with a
# per-chain pool size, and the logit delta on the augmented rows [x, 1]
# ---------------------------------------------------------------------------

# (K replicas, N points, K_max, P steps, D, points): the main path's shape
# cut to N = 2000; one replica; three clusters all occupied (no empty slot:
# slot 0 is the auxiliary); 32 clusters on a full warp at D = 3; D = 1 with
# points that repeat within the sweep; P not a multiple of 32; each point
# visited twice in a row at K_max = 4 (the next step's old cluster is the
# one this step picks, and the auxiliary slot moves often); a cluster of a
# single point whose removal empties it, at K_max = 4, so that the
# auxiliary lands on it; D = 4 at K_max = 12; sweeps of one and two points.
# Points are "distinct" (a prefix of a permutation),
# "random" (with repeats), "pairs" or "singleton" (distinct, and the
# replica's r-th visited point alone in cluster K_max - 1 before the sweep)
_GIBBS_CASES = {
    "K8_N2000_P1000": (8, 2000, 20, 1000, 2, "distinct"),
    "K1_N600_P300": (1, 600, 20, 300, 2, "distinct"),
    "kmax3_full": (3, 500, 3, 500, 2, "distinct"),
    "kmax32_D3": (4, 700, 32, 333, 3, "distinct"),
    "D1_repeats": (2, 300, 5, 777, 1, "random"),
    "kmax4_pairs": (3, 400, 4, 600, 2, "pairs"),
    "kmax4_singleton": (4, 500, 4, 400, 2, "singleton"),
    "kmax12_D4": (2, 800, 12, 400, 4, "distinct"),
    "P1": (3, 200, 6, 1, 2, "distinct"),
    "P2": (3, 200, 6, 2, 3, "distinct"),
}
_SINGLETON_STEPS = (0, 1, 37, 399)  # the step at which each replica visits its lone point
# beyond shared memory: the kernel keeps z's bytes and then the count table
# over as many counts as fit in a block's shared memory, and a count past the
# table computes its terms where it needs them. N = 60 000: the table holds
# counts up to ~42 800, every count of the case (~20 000 a cluster); N =
# 150 000: up to ~20 300, the clusters' ~50 000 past it; N = 232 000: z in
# device memory, the table up to ~57 800, the clusters' ~77 000 past it
_GIBBS_LARGE = {"N60000_table_cut_short": (2, 60_000, 8, 300, 2, "distinct"),
                "N150000_counts_past_the_table": (2, 150_000, 8, 300, 2, "distinct"),
                "N232000_z_in_device_memory": (1, 232_000, 8, 300, 2, "distinct")}


def _gibbs_inputs(case, dev):
    """Data, state and staged randomness of one case, from numpy."""
    from repro_torch.inference.niw import ClusterStats, NIWPrior

    k, n, k_max, p, d, kind = {**_GIBBS_CASES, **_GIBBS_LARGE}[case]
    rng = np.random.default_rng([k, n, k_max, p, d])
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    centers = rng.normal(0, 2.5, (4, d))
    x = centers[rng.integers(0, 4, n)] + 0.7 * rng.standard_normal((n, d))
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    z = rng.integers(0, min(3, k_max), (k, n)).astype(np.int32)
    w = rng.standard_normal((k, k_max, d + 1))
    log_alpha = np.log(rng.uniform(0.3, 2.0, k))
    if kind == "random":
        points = rng.integers(0, n, (k, p))
    elif kind == "pairs":
        points = np.stack([np.repeat(rng.permutation(n)[:p // 2], 2) for _ in range(k)])
    else:
        points = np.stack([rng.permutation(n)[:p] for _ in range(k)])
    if kind == "singleton":
        for r in range(k):
            z[r, points[r, _SINGLETON_STEPS[r]]] = k_max - 1
    nrm = rng.standard_normal((k, p, d + 1))
    u = rng.uniform(size=(k, p))
    z_t = torch.tensor(z, device=dev)
    stats = ClusterStats.from_assignments(f32(x), z_t, k_max)
    prior = NIWPrior(torch.zeros(d, device=dev), 0.1, 4.0, torch.eye(d, device=dev))
    return (f32(x), f32(y), z_t, f32(w), f32(log_alpha), stats,
            torch.tensor(points.astype(np.int32), device=dev), f32(nrm), f32(u), prior)


def _gibbs_digest(case, dev) -> str:
    """sha256 (first 16 hex digits) of z, w, n, sum_x and sum_xxt after one
    launch of the sweep kernel on the case's inputs."""
    from repro_torch.inference.niw import ClusterStats

    x, y, z, w, la, stats, points, nrm, u, prior = _gibbs_inputs(case, dev)
    sk = ClusterStats(*(s.clone() for s in stats))
    ops.gibbs_z_sweep(x, y, z, w, la, sk, points, nrm, u, prior, 1.0, mode="always")
    return _outputs_digest([z, w, *sk])


# _gibbs_digest of each case from the kernel that recomputed every
# cluster's whole predictive at every step on one warp, which the kernel
# that speculates the next step must reproduce bit for bit
_GIBBS_DIGESTS = {"K8_N2000_P1000": "0d3f854f9722765b", "K1_N600_P300": "d6fe913711fe614d",
                  "kmax3_full": "f8c8afeadcaf27f2", "kmax32_D3": "ebc083fc56ad2e7a",
                  "D1_repeats": "cad4fcf2c2844676", "kmax4_pairs": "dc153e3d8c90911d",
                  "kmax4_singleton": "b9064f96cd87f5a8", "kmax12_D4": "9ab6ef5bedaee3da",
                  "P1": "a5c39d58faf44d50", "P2": "e07cd78f119d8012",
                  "N60000_table_cut_short": "16acba088d51a2e9",
                  "N150000_counts_past_the_table": "d97dfa0549bcba06",
                  "N232000_z_in_device_memory": "4d669fcc772281b3"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*_GIBBS_CASES, *_GIBBS_LARGE])
def test_gibbs_z_kernel_reproduces_parent_bits(case, cuda_device):
    """z, w and the statistics after one launch equal, bit for bit, what
    the kernel that recomputed the whole predictive at every step gave
    from the same inputs: caching and speculating change when each float32
    value is computed, not how."""
    assert _gibbs_digest(case, cuda_device) == _GIBBS_DIGESTS[case]


def _check_gibbs_against_plain(case, dev):
    from repro_torch.inference.niw import ClusterStats
    from repro_torch.kernels.gibbs_z import first_divergence, gibbs_z_sweep_ref, sums_drift

    x, y, z, w, la, stats, points, nrm, u, prior = _gibbs_inputs(case, dev)
    k_max = w.shape[1]
    zk, wk = z.clone(), w.clone()
    sk = ClusterStats(*(s.clone() for s in stats))
    ops.reset_launches()
    ops.gibbs_z_sweep(x, y, zk, wk, la, sk, points, nrm, u, prior, 1.0, mode="always")
    assert ops.launches["gibbs_z_sweep"] == 1
    zp, wp = z.clone(), w.clone()
    sp = ClusterStats(*(s.clone() for s in stats))
    cdf, mass = gibbs_z_sweep_ref(x, y, zp, wp, la, sp, points, nrm, u, prior, 1.0, record=True)
    if {**_GIBBS_CASES, **_GIBBS_LARGE}[case][5] in ("distinct", "singleton"):
        for r, t, borderline in first_divergence(points, u, zk, zp, cdf, mass):
            assert borderline, f"replica {r} picks apart at step {t}, away from a CDF boundary"
        visited = torch.zeros_like(z, dtype=torch.bool).scatter_(1, points.long(), True)
        assert torch.equal(zk[~visited], z[~visited])
    else:
        assert float((zk == zp).float().mean()) >= 0.9
    assert bool(((zk >= 0) & (zk < k_max)).all())
    counts = torch.stack([torch.bincount(r.long(), minlength=k_max) for r in zk]).float()
    assert torch.equal(sk.n, counts)
    assert sums_drift(sk, ClusterStats.from_assignments(x, zk, k_max)) <= 1e-5
    assert bool(torch.isfinite(wk).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_GIBBS_CASES))
def test_gibbs_z_kernel_matches_plain(case, cuda_device):
    """The sweep from the same state and random numbers, one launch: every
    replica's picks equal the plain version's, or the first pick that
    differs has its uniform within 1e-5 of a CDF boundary (the math
    functions round differently; everything after it follows another
    state). The kernel's counts equal its z's histogram exactly and its
    sums are within 1e-5 of their largest magnitude of sums recomputed from
    its z in float64 (float32 adds and removes round to the running sum's
    ulp); with distinct points, points outside the sweep keep their
    cluster."""
    _check_gibbs_against_plain(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_GIBBS_LARGE))
def test_gibbs_z_kernel_beyond_shared_memory(case, cuda_device):
    """As test_gibbs_z_kernel_matches_plain, where the count table no
    longer holds every count 0 .. N (N = 60 000, 150 000) and z's bytes no
    longer fit in a block's shared memory (N = 232 000, up to MAX_POINTS)."""
    _check_gibbs_against_plain(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _ROUND_CASES)
def test_round_kernel_per_chain_n_total_gives_scalar_bits(case, cuda_device):
    """A (K,) ``n_total`` holding the scalar everywhere gives, bit for bit,
    the outputs of the scalar form (the block-per-chain kernel's digest)."""
    def per_chain(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds, *rest):
        sizes = torch.full_like(mu0, float(n_total))
        ops.t_test_round(l, valid, count, mean, m2, mu0, eps, sizes, max_rounds, *rest,
                         mode="always")

    assert _digest(_run_rounds(case, cuda_device, per_chain)) == _ROUND_DIGESTS[case]


@pytest.mark.cuda
def test_round_kernel_ragged_n_total_matches_plain(cuda_device):
    """K = 8 chains of the DP mixture's w move, m = 100, each against its
    own pool size N_k (40 .. 5000), some exhausted within the three rounds:
    counts, rounds, done flags and decisions identical to the plain
    version's; mean, m2 and p-value within 1e-4 relative."""
    rng = np.random.default_rng(19)
    k, m = 8, 100
    sizes = np.array([40, 150, 260, 400, 999, 1500, 3000, 5000], np.float32)
    count = np.minimum(rng.integers(0, 300, k), sizes - 1).astype(np.float32)
    count[:3] = np.float32([0, 100, 200])
    mean = rng.normal(0, 0.05, k).astype(np.float32)
    m2 = (np.maximum(count - 1, 0) * rng.uniform(0.5, 2.0, k)).astype(np.float32)
    mu0 = rng.normal(0, 0.05, k).astype(np.float32)
    left = np.maximum(sizes - count, 0)
    batches = []
    for r in range(3):
        l = (mean[:, None] + rng.standard_normal((k, m))).astype(np.float32)
        valid = np.arange(m)[None, :] < np.minimum(m, left - r * m)[:, None]
        batches.append((l, valid))
    outs = []
    for mode in ("always", "never"):
        st = [torch.tensor(a, device=cuda_device) for a in (count, mean, m2)]
        rest = [torch.zeros(k, dtype=torch.int32, device=cuda_device),
                torch.zeros(k, dtype=torch.bool, device=cuda_device),
                torch.zeros(k, dtype=torch.bool, device=cuda_device),
                torch.ones(k, device=cuda_device)]
        after = []
        for l, valid in batches:
            ops.t_test_round(torch.tensor(l, device=cuda_device),
                             torch.tensor(valid, device=cuda_device), *st,
                             torch.tensor(mu0, device=cuda_device),
                             torch.full((k,), 0.05, device=cuda_device),
                             torch.tensor(sizes, device=cuda_device), 123, *rest, mode=mode)
            after.append([t.clone() for t in st + rest])
        outs.append(after)
    assert bool(outs[0][-1][4][:2].all())  # the two smallest pools are exhausted
    for g, w in zip(*outs):
        for i in (0, 3, 4, 5):  # count, rounds, done, decision
            assert torch.equal(g[i], w[i])
        for i in (1, 2, 6):  # mean, m2, pval
            torch.testing.assert_close(g[i], w[i], rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_logit_delta_on_augmented_rows(cuda_device):
    """The DP mixture's w move scores x_aug = [x, 1] (N = 10 000, D + 1 = 3):
    the gathered K = 8 round and the one-replica form against the plain
    version, and the one-replica form equal bit for bit to the gathered
    form's row at K = 1 (what an ensemble of one replica relies on)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    n, k, m = 10_000, 8, 100
    x = torch.randn(n, 2, generator=gen, device=cuda_device) * 2.0
    x_aug = torch.cat([x, torch.ones(n, 1, device=cuda_device)], 1).contiguous()
    y = torch.where(torch.rand(n, generator=gen, device=cuda_device) < 0.5, 1.0, -1.0)
    w = torch.randn(k, 3, generator=gen, device=cuda_device)
    wp = w + 0.3 * torch.randn(k, 3, generator=gen, device=cuda_device)
    idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
    for mode_run in (lambda mode: ops.gather_and_delta(x_aug, y, idx, w, wp, mode=mode),
                     lambda mode: ops.logit_delta(x_aug, y, w[0], wp[0], idx=idx[0], mode=mode)):
        torch.testing.assert_close(mode_run("always"), mode_run("never"), rtol=FP32_TOL,
                                   atol=FP32_TOL)
    one = ops.logit_delta(x_aug, y, w[0], wp[0], idx=idx[0], mode="always")
    assert torch.equal(one, ops.gather_and_delta(x_aug, y, idx[:1], w[:1], wp[:1], mode="always")[0])


def _compiled_program(name, dev, n):
    """A compiled BayesLR (D = 50) or AR(1) program on the card, written
    against ``repro_torch.ppl``, on data made from a seed."""
    from repro_torch.ppl import Trace, compile_partitioned_target, dists

    gen = torch.Generator(device=dev).manual_seed(9)
    tr = Trace(device=dev)
    if name == "logit":
        d = 50
        x = torch.randn(n, d, generator=gen, device=dev) / d ** 0.5
        y = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 1.0, -1.0)
        v = tr.sample("w", dists.mvnormal_diag, tr.constant("mu_w", torch.zeros(d)),
                      tr.constant("sig_w", torch.full((d,), 0.1 ** 0.5)), value=torch.zeros(d))
        with tr.plate("data", n):
            z = tr.det("z", lambda xx, ww: xx @ ww, tr.constant("x", x), v)
            tr.observe(tr.sample("y", dists.bernoulli_logits, z, value=y), y)
    else:
        eps = 0.3 * np.random.default_rng(9).standard_normal(n + 1)
        series = np.zeros(n + 1, np.float32)
        for t in range(1, n + 1):  # x_t = 0.8 x_{t-1} + 0.3 eps_t
            series[t] = 0.8 * series[t - 1] + eps[t]
        series = torch.tensor(series, device=dev)
        v = tr.sample("phi", dists.normal, tr.constant("m0", 0.0), tr.constant("s0", 1.0),
                      value=torch.tensor(0.5))
        sigma = tr.constant("sigma", 0.3)
        with tr.plate("steps", n):
            mu = tr.det("mu", lambda xp, ph: ph * xp, tr.constant("x_prev", series[:-1]), v)
            tr.observe(tr.sample("x", dists.normal, mu, sigma, value=series[1:]), series[1:])
    return compile_partitioned_target(tr, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logit", "ar1"])
def test_compiled_program_ensemble_kernel_matches_plain(name, cuda_device):
    """A compiled program's (K, m) rounds (K = 32, m = 100) launch its
    family's kernel and agree with the plain route (the pair delta within
    1e-5, the AR(1) delta as its own card cases hold it)."""
    target = _compiled_program(name, cuda_device, 12214 if name == "logit" else 100_000)
    assert target.family == {"logit": "logit", "ar1": "gaussian_ar1"}[name]
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    k, m, n = 32, 100, target.num_sections
    shape = (k, 50) if name == "logit" else (k,)
    th = (0.3 if name == "logit" else 0.05) * torch.randn(shape, generator=gen, device=cuda_device)
    thp = th + 0.05 * torch.randn(shape, generator=gen, device=cuda_device)
    if name == "ar1":
        th, thp = th + 0.5, thp + 0.5
    idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
    ops.reset_launches()
    got = target.log_local_ensemble(th, thp, idx, mode="always")
    kernel = {"logit": "batched_logit_delta", "ar1": "gaussian_ar1_delta"}[name]
    assert ops.launches[kernel] == 1, dict(ops.launches)
    want = target.log_local_ensemble(th, thp, idx, mode="never")
    tol = dict(rtol=FP32_TOL, atol=FP32_TOL) if name == "logit" else dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    assert target.log_global(th, thp).shape == (k,)


@pytest.mark.cuda
def test_trial_run_report_runs_the_kernels(cuda_device):
    """The safeguard on a hand-built logit target: its exact pass is the
    pair delta's range form, its rounds the one-chain pair delta, the
    Fisher–Yates draw and the round op."""
    from repro_torch.core import RandomWalk, trial_run_report
    from repro_torch.experiments import bayeslr

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    n, d = 2000, 5
    x, y = _pool(gen, cuda_device, n, d, torch.float32)
    target = bayeslr.make_target(x, y)
    assert target.range_sections
    ops.reset_launches()
    rep = trial_run_report(12, torch.zeros(d), target, RandomWalk(0.05), batch_size=50,
                           epsilon=0.05, num_trials=5)
    torch.cuda.synchronize()
    for name in ("logit_delta", "fy_draw", "t_test_round"):
        assert ops.launches[name] > 0, dict(ops.launches)
    assert rep.num_trials == 5 and 0.0 < rep.mean_fraction_evaluated <= 1.0
    assert np.isfinite(rep.jb_stat_mean) and 0.0 <= rep.jb_pvalue_min <= 1.0


# ---------------------------------------------------------------------------
# Posterior serving on the card
# ---------------------------------------------------------------------------


def _serving_window(name, rng, k=8, w=128):
    """A (K, W, ...) window at the serving workloads' full widths and 64
    request rows (feature points, or quantile levels for stochvol)."""
    from repro_torch.inference.niw import ClusterStats

    if name == "bayeslr":
        return rng.normal(0, 0.5, (k, w, 20)).astype(np.float32), \
            rng.normal(0, 1, (64, 20)).astype(np.float32)
    if name == "stochvol":
        return {"phi": rng.uniform(0.5, 0.99, (k, w)).astype(np.float32),
                "sigma2": rng.uniform(0.01, 0.1, (k, w)).astype(np.float32)}, \
            rng.uniform(0.05, 0.95, 64).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 2, (5000, 2)).astype(np.float32))
    st = ClusterStats.from_assignments(x, torch.from_numpy(rng.integers(0, 4, (k * w, 5000))), 20)
    shape = lambda t: t.numpy().reshape((k, w) + tuple(t.shape[1:]))
    return {"w": rng.normal(0, 1, (k, w, 20, 3)).astype(np.float32),
            "alpha": np.ones((k, w), np.float32),
            "stats": ClusterStats(*(shape(t) for t in st))}, \
        rng.normal(0, 2, (64, 2)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cls", [("bayeslr", "predictive"), ("bayeslr", "vote"),
                                      ("stochvol", "vol_quantile"),
                                      ("jointdpm", "cluster_predictive")])
def test_serving_batch_transparency_on_card(name, cls, cuda_device):
    """A request served inside a batch returns exactly what it returns
    alone on the card (the evaluator's stream, cuBLAS at one (S, mb) shape,
    no TF32): 40 rows at once equal them in chunks of 8 and one by one, at
    S = 1024 draws; and they agree with the CPU's evaluation to fp32."""
    from repro_torch.serving import Snapshot, build_serving_workload
    from repro_torch.serving.resident import SnapshotEvaluator

    torch.backends.cuda.matmul.allow_tf32 = False
    small = {"bayeslr": dict(n_train=500, d=20), "stochvol": dict(num_series=20, length=4),
             "jointdpm": dict(n=200)}[name]
    spec = build_serving_workload(name, smoke=True, num_chains=2, device=cuda_device,
                                  **small).query_specs[cls]
    draws, xs = _serving_window(name, np.random.default_rng(0))
    xs = xs[:40]
    snap = Snapshot(draws, 1024, 128, 0.0, {}, 0.0)
    ev = SnapshotEvaluator(64, cuda_device)
    whole = ev.evaluate(spec, snap, xs)
    parts = np.concatenate([ev.evaluate(spec, snap, xs[i:i + 8]) for i in range(0, 40, 8)])
    ones = np.concatenate([ev.evaluate(spec, snap, xs[i:i + 1]) for i in range(40)])
    np.testing.assert_array_equal(whole, parts)
    np.testing.assert_array_equal(whole, ones)
    cpu_spec = build_serving_workload(name, smoke=True, num_chains=2, device="cpu",
                                      **small).query_specs[cls]
    cpu = SnapshotEvaluator(64, "cpu").evaluate(cpu_spec, snap, xs)
    np.testing.assert_allclose(whole, cpu, rtol=1e-4, atol=1e-5)


def _card_pool(cuda_device, **kw):
    from repro_torch.serving import EnsemblePool, FreshnessPolicy, ServingConfig

    cfg = ServingConfig(num_chains=8, refresh_steps=16, window=32, micro_batch=64,
                        freshness=FreshnessPolicy(min_draws=64), device=cuda_device, **kw)
    pool = EnsemblePool(cfg)
    pool.add_workload("bayeslr", n_train=12_000, d=20, batch_size=500)
    return pool


@pytest.mark.cuda
def test_serving_chunked_refresh_equals_one_shot_on_card(cuda_device):
    """Refreshes of 16, 8 and 4 steps on the card equal one offline run of
    28 steps on a CUDA generator seeded alike, bit for bit, through the
    pair-delta kernel and the round op."""
    pool = _card_pool(cuda_device, seed=5)
    resident = pool.resident("bayeslr")
    ops.reset_launches()
    for n in (16, 8, 4):
        resident.refresh(n)
    assert ops.launches["batched_logit_delta"] > 0 and ops.launches["t_test_round"] > 0
    ens = pool.workload("bayeslr").ensemble
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    state, samples, _ = ens.run(gen, ens.init(pool.workload("bayeslr").theta0), 28)
    np.testing.assert_array_equal(resident.snapshot().draws, samples.cpu().numpy())
    assert torch.equal(resident.state.theta, state.theta)
    assert torch.equal(resident._gen_state, gen.get_state())


@pytest.mark.cuda
def test_serving_cuda_generator_survives_save_restore(cuda_device, tmp_path):
    """``pool.save`` holds the CUDA generator's 16-byte state; a fresh
    pool's ``restore`` and 8 more steps on each equal each other bit for
    bit. A checkpoint taken on the CPU refuses the CUDA pool."""
    from repro_torch.serving import EnsemblePool, FreshnessPolicy, ServingConfig

    pool = _card_pool(cuda_device)
    pool.warm()
    pool.save(str(tmp_path / "card"))
    other = _card_pool(cuda_device)
    assert other.restore(str(tmp_path / "card")) == pool.resident("bayeslr").steps_done
    a, b = pool.resident("bayeslr"), other.resident("bayeslr")
    assert a._gen_state.numel() == 16 and torch.equal(a._gen_state, b._gen_state)
    a.refresh(8)
    b.refresh(8)
    assert torch.equal(a.state.theta, b.state.theta)
    np.testing.assert_array_equal(a.snapshot().draws, b.snapshot().draws)
    cfg = ServingConfig(num_chains=8, refresh_steps=16, window=32,
                        freshness=FreshnessPolicy(min_draws=64), device="cpu")
    cpu_pool = EnsemblePool(cfg)
    cpu_pool.add_workload("bayeslr", n_train=12_000, d=20, batch_size=500)
    cpu_pool.resident("bayeslr").refresh(2)
    cpu_pool.save(str(tmp_path / "cpu"))
    with pytest.raises(ValueError, match="device type"):
        _card_pool(cuda_device).restore(str(tmp_path / "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_mesh_round_on_card_slots_is_the_whole_round(precision, cuda_device, monkeypatch):
    """A 2 x 2 mesh of four slots on the card: each (K, m) round split chains
    x data, every slot's block scored by the pair-delta kernel, equals the
    whole round bit for bit, at C's shape (K = 32, m = 100, N = 12 214,
    D = 50) and at L's m_max = 400, with one launch a slot a round."""
    from repro_torch.core import build_target
    from repro_torch.distributed import Mesh, logical_axis_rules

    monkeypatch.setenv("REPRO_PRECISION", precision)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    n, d, k = 12214, 50, 32
    x = torch.randn((n, d), generator=gen, device=cuda_device)
    y = torch.where(torch.rand(n, generator=gen, device=cuda_device) < 0.5, 1.0, -1.0)
    target = build_target("logit", (x, y), n, prior_logpdf=lambda w: -(w ** 2).sum(-1))
    th = 0.3 * torch.randn((k, d), generator=gen, device=cuda_device)
    thp = th + 0.05 * torch.randn((k, d), generator=gen, device=cuda_device)
    slots = np.empty(4, dtype=object)
    slots[:] = [torch.device("cuda", torch.cuda.current_device())] * 4
    mesh = Mesh(slots.reshape(2, 2), ("chains", "data"))
    for m in (100, 400):
        idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
        whole = target.local_round(th, thp, ensemble=True, mode="always")(idx)
        ops.reset_launches()
        with logical_axis_rules(mesh):
            got = target.local_round(th, thp, ensemble=True, mode="always")(idx)
        torch.cuda.synchronize()
        assert torch.equal(got, whole), (m, float((got - whole).abs().max()))
        per_slot = {s: ops.slot_launches[(s, "batched_logit_delta")]
                    for s in ((0, 0), (0, 1), (1, 0), (1, 1))}
        assert per_slot == dict.fromkeys(per_slot, 1), dict(ops.slot_launches)
        assert ops.launches["batched_logit_delta"] == 4


# ---------------------------------------------------------------------------
# shard="auto" on several cards; the LM's cached step, flash attention and
# the xLSTM family on the card
# ---------------------------------------------------------------------------


def _ensemble_run(data, shard, steps, dev):
    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig
    from repro_torch.experiments import bayeslr

    gen = torch.Generator(device=dev).manual_seed(7)
    target = bayeslr.make_target(data.x_train, data.y_train)
    ens = ChainEnsemble(target, RandomWalk(0.05), 32, device=dev, shard=shard,
                        config=SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream"))
    theta0 = 0.5 * torch.randn(32, data.x_train.shape[1], generator=gen, device=dev)
    state0 = ens.init(theta0, batched=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, samples, infos = ens.run(gen, state0, steps)
    torch.cuda.synchronize()
    return samples, infos, 32 * steps / (time.perf_counter() - t0)


def _ce_ensemble_run(target, theta, shard, steps, dev):
    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig

    ens = ChainEnsemble(target, RandomWalk(1.2e-4), theta.shape[0], device=dev, shard=shard,
                        config=SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="fy"),
                        collect=lambda t: t[:, :2, :4].clone())
    state0 = ens.init(theta, batched=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, samples, infos = ens.run(41, state0, steps)
    torch.cuda.synchronize()
    return samples, infos, theta.shape[0] * steps / (time.perf_counter() - t0), ens._mesh


def _j_shaped_ce(dev):
    """J's shape: a pool of N = 8 128 bf16 rows of width 4 096 with next
    tokens of a 65 024 vocabulary, and K = 8 per-chain fp32 tables (random,
    seeded), under a Gaussian prior."""
    from repro_torch.core import build_target

    gen = torch.Generator(device=dev).manual_seed(12)
    n, d, v, k = 8128, 4096, 65024, 8
    h = (torch.randn(n, d, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
    tokens = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    target = build_target("ce", (h, tokens), n,
                          prior_logpdf=lambda t: -0.5 * (t * t).sum((-2, -1)))
    theta = 0.02 * torch.randn(k, v, d, generator=gen, device=dev)
    return target, theta


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logit", "ce"])
def test_shard_auto_against_unsharded_on_cards(family, cuda_device):
    """The chain mesh on every visible card (two or more) against
    ``shard=False``, in turns (plain, mesh, mesh, plain): BayesLR at phase
    C's setting (K = 32, m = 100, N = 12 214, D = 50), 100 steps; and the
    ``ce`` family at J's shape (K = 8 per-chain tables, m = 100 of N =
    8 128; two chains a card on four cards), 10 steps. Samples and infos
    bit for bit; both rates are printed. ``shard="auto"`` builds no mesh
    on cards (the rule of ``ChainEnsemble``'s docstring, which these rates
    chose) and is bit for bit too. Skips on one card."""
    from repro_torch.experiments import bayeslr

    if torch.cuda.device_count() < 2:
        pytest.skip("shard='auto' spreads over several cards; this machine has one")
    if family == "logit":
        data = bayeslr.synth_mnist_like(0, device=cuda_device)
        run = lambda shard: _ensemble_run(data, shard, 100, cuda_device)  # noqa: E731
    else:
        target, theta = _j_shaped_ce(cuda_device)
        run = lambda shard: _ce_ensemble_run(target, theta, shard, 10, cuda_device)[:3]  # noqa
    rates, out = {}, {}
    for shard in (False, True, True, False):  # in turns: plain, mesh, mesh, plain
        samples, infos, rate = run(shard)
        rates.setdefault(str(shard), []).append(rate)
        out[str(shard)] = (samples, infos)
    samples, infos, _ = run("auto")
    out["auto"] = (samples, infos)
    for key in ("True", "auto"):
        assert torch.equal(out[key][0], out["False"][0]), key
        for a, b in zip(out[key][1], out["False"][1]):
            assert torch.equal(a, b), key
    if family == "ce":
        assert _ce_ensemble_run(target, theta, "auto", 1, cuda_device)[3] is None
    print(f"\n{family}: the chain mesh on {torch.cuda.device_count()} cards: transitions/s "
          f"{rates['True']} against shard=False {rates['False']} "
          f"({torch.cuda.get_device_name(0)})")


def _lm_case(dev, pool=8, seq=16):
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models import init_params

    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device=dev)
    batch = TokenStream(DataConfig(cfg.vocab, seq, pool, 0), device=dev).batch(0)
    return cfg, params, batch


@pytest.mark.cuda
def test_cached_step_equals_uncached_step_on_card(cuda_device):
    """The lazy log-likelihood cache changes no bit: 8 steps from one
    generator seed give the same decisions, rounds, n_evaluated and mu_hat
    and the same final parameters as the plain step, at reduced width."""
    from repro_torch.bayes import (LogLikCache, TrainConfig, make_cached_train_step,
                                   make_train_step)

    cfg, params, batch = _lm_case(cuda_device)
    tc = TrainConfig(round_batch=2, epsilon=0.2, sigma=1e-3)
    plain, cached = make_train_step(cfg, tc), make_cached_train_step(cfg, tc)
    g1 = torch.Generator(device=cuda_device).manual_seed(5)
    g2 = torch.Generator(device=cuda_device).manual_seed(5)
    th1 = th2 = params
    cache = LogLikCache.empty(8, device=cuda_device)
    accepted = 0
    for _ in range(8):
        th1, i1 = plain(g1, th1, batch)
        th2, cache, i2 = cached(g2, th2, batch, cache)
        for f in ("accepted", "rounds", "n_evaluated", "mu_hat", "mu0"):
            assert torch.equal(getattr(i1, f), getattr(i2, f)), f
        accepted += int(i1.accepted)
    assert 0 < accepted < 8
    assert np.array_equal(cache.valid.cpu().numpy(), cache.valid_host)
    for a, b in zip(_leaves(th1), _leaves(th2)):
        assert torch.equal(a, b)


def _leaves(tree):
    from repro_torch._device import tree_leaves

    return tree_leaves(tree)


@pytest.mark.cuda
def test_flash_attention_against_dense_at_chatglm_heads(cuda_device):
    """``_attend_flash`` against ``_attend_dense`` on the same bf16 q/k/v at
    chatglm3-6b's head shape (32 query heads over 2 kv heads, hd 128) and
    2 304 rows, causal, full window: the two round their bf16 products at
    other places (chunked p against the whole softmax), so the bar is bf16's:
    RMS of the difference within 1e-2 of the output's RMS, max within 5e-2
    of its largest magnitude."""
    from repro_torch.models.layers import _attend_dense, _attend_flash

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, kv, g, hd = 1, 2304, 2, 16, 128
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = rnd(b, s, kv, g, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    pos = torch.arange(s, device=cuda_device)
    dense = _attend_dense(q, k, v, pos, pos, 1 << 30, True, hd ** -0.5).float()
    flash = _attend_flash(q, k, v, pos, pos, 1 << 30, True, hd ** -0.5).float()
    assert flash.shape == dense.shape and bool(torch.isfinite(flash).all())
    rms = lambda t: float(t.pow(2).mean().sqrt())
    assert rms(flash - dense) <= 1e-2 * rms(dense)
    assert float((flash - dense).abs().max()) <= 5e-2 * float(dense.abs().max())


@pytest.mark.cuda
def test_xlstm_forward_on_card_matches_cpu(cuda_device):
    """xlstm-350m's family at reduced width, in float32: hidden states and
    per-sequence log-likelihoods on the card equal the CPU's within 1e-4 of
    their largest magnitude and 1e-5 relative (TF32 off)."""
    from repro_torch._device import tree_map
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import forward_hidden, forward_loglik, init_params

    cfg = reduce_config(ARCHS["xlstm-350m"])
    cpu = tree_map(lambda t: t.float(), init_params(0, cfg, device="cpu"))
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    tok = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, (3, 24)), dtype=torch.int32)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h_cpu = forward_hidden(cpu, tok, cfg)
        h_card = forward_hidden(card, tok.to(cuda_device), cfg).cpu()
        l_cpu = forward_loglik(cpu, {"tokens": tok}, cfg)
        l_card = forward_loglik(card, {"tokens": tok.to(cuda_device)}, cfg).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert float((h_card - h_cpu).abs().max()) <= 1e-4 * float(h_cpu.abs().max())
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-5)


def _moe_case(seed, b, s, dev, d=64, f=128, e=8):
    """bf16 inputs of ``moe_mlp`` from a numpy seed: x (b, s, d), a router
    and e experts at the init scales of the LM's leaves."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.tensor(a, dtype=torch.float32).to(dev, torch.bfloat16)  # noqa: E731
    x = bf(rng.standard_normal((b, s, d)))
    p = {"router": bf(rng.standard_normal((d, e)) * d ** -0.5),
         "wi_gate": bf(rng.standard_normal((e, d, f)) * d ** -0.5),
         "wi_up": bf(rng.standard_normal((e, d, f)) * d ** -0.5),
         "wo": bf(rng.standard_normal((e, f, d)) * f ** -0.5)}
    return x, p


@pytest.mark.cuda
def test_moe_on_card_is_bit_for_bit_with_drops(cuda_device):
    """``moe_mlp`` in bf16 on the card, 8 x 256 tokens at capacity factor
    0.5 (one group; capacity 256 against a mean load of 512 an expert: 2 048
    of the 4 096 assignments drop on the CPU), called twice: equal bit for bit, as the combine adds
    each token's k rows in k order with no atomics."""
    from repro_torch.models.layers import moe_mlp, record_moe_drops

    x, p = _moe_case(0, 8, 256, cuda_device)
    with record_moe_drops() as log:
        a = moe_mlp(x, p, top_k=2, capacity_factor=0.5)
        b = moe_mlp(x, p, top_k=2, capacity_factor=0.5)
    dropped = int(sum(int(n) for _, n in log))
    assert dropped > 0 and torch.equal(a, b)
    assert bool(torch.isfinite(a.float()).all())


@pytest.mark.cuda
def test_moe_on_card_matches_cpu(cuda_device):
    """``moe_mlp`` in bf16 on the card against the CPU on the same inputs,
    at the bf16 bar of the forward (RMS of the difference within 5e-2 of
    the output's RMS). A router near-tie could send a token to another
    expert on the two devices, so the case asserts its precondition on the
    CPU's router logits (k-th and (k+1)-th more than 2 bf16 ulps apart on
    every token); the inputs' numpy seed is the first from 0 up for which
    it holds."""
    from repro_torch._device import tree_map
    from repro_torch.models.layers import moe_mlp

    for seed in range(30):
        x, p = _moe_case(seed, 2, 16, torch.device("cpu"))
        top = torch.sort(torch.einsum("bsd,de->bse", x, p["router"]).float(), dim=-1,
                         descending=True).values
        ulp = 2.0 ** (torch.floor(torch.log2(top[..., 1].abs().clamp_min(1e-30))) - 7)
        if bool(((top[..., 1] - top[..., 2]) / ulp > 2).all()):
            break
    else:
        pytest.fail("no seed of 30 meets the router-gap precondition")
    want = moe_mlp(x, p, top_k=2).float()
    got = moe_mlp(x.to(cuda_device), tree_map(lambda t: t.to(cuda_device), p), top_k=2)
    rms = lambda t: float(t.pow(2).mean().sqrt())  # noqa: E731
    assert rms(got.float().cpu() - want) <= 5e-2 * rms(want)


@pytest.mark.cuda
def test_whisper_decode_on_card_gives_finite_logits(cuda_device):
    """whisper-base at reduced width on the card: a prefill that encodes
    bf16 frames, then four decode steps whose cross-attention reads the
    cached encoder output; every logit finite, the cache's length advanced."""
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = reduce_config(ARCHS["whisper-base"])
    params = init_params(0, cfg, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 8), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    frames = 0.1 * torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=gen,
                               device=cuda_device, dtype=torch.bfloat16)
    cache, logits = prefill(params, tok, cfg, 16, {"frames": frames})
    finite = [bool(torch.isfinite(logits).all())]
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(4):
        cache, logits = decode_step(params, cache, nxt, cfg)
        finite.append(bool(torch.isfinite(logits).all()))
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
    assert all(finite) and int(cache["len"]) == 12
    assert tuple(cache["enc_out"].shape) == (2, cfg.n_audio_frames, cfg.d_model)


# ---------------------------------------------------------------------------
# The launch-parameter tuner (repro_torch.kernels.autotune): the bit rule
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tuned_cases(family, prec, dev):
    """(label, run(**launch)) pairs of ``family``'s kernel wrapper at the main
    path's shapes and ragged ones, in ``prec`` (bf16: bf16 rows, and fp32
    rows rounded in the kernel)."""
    from repro_torch.kernels import batched_loglik, fused_ce, gaussian_ar1, logit_loglik

    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, family)))
    bf16 = prec == "bf16"
    cases = []
    if family in ("logit_delta", "batched_loglik"):
        for d in (3, 50):
            for offset in (0, 1):
                x, y = _pool(gen, dev, 12214, d, torch.bfloat16 if bf16 else torch.float32,
                             offset)
                for k, m in ((1, 1), (1, 37), (1, 100), (32, 100), (32, 400), (33, 37), (8, 100)):
                    if (k == 1) != (family == "logit_delta"):
                        continue
                    w = torch.randn(k, d, generator=gen, device=dev)
                    wp = w + 0.05 * torch.randn(k, d, generator=gen, device=dev)
                    idx = torch.randint(0, 12214, (k, m), generator=gen, device=dev,
                                        dtype=torch.int32)
                    label = f"D={d} offset={offset} K={k} m={m}"
                    if family == "logit_delta":
                        cases.append((label, lambda x=x, y=y, w=w, wp=wp, i=idx, **kw:
                                      logit_loglik.logit_delta(x, y, w[0], wp[0], idx=i[0], **kw)))
                    else:
                        xg, yg = x[idx.long()].contiguous(), y[idx.long()].contiguous()
                        cases.append((label, lambda x=x, y=y, w=w, wp=wp, i=idx, **kw:
                                      batched_loglik.gather_and_delta(x, y, i, w, wp, **kw)))
                        cases.append((label + " pre-gathered", lambda xg=xg, yg=yg, w=w, wp=wp, **kw:
                                      batched_loglik.batched_logit_delta(xg, yg, w, wp, **kw)))
        if family == "logit_delta":  # the exact passes: contiguous runs, short and long
            for n in (12214, 1_000_000):
                x, y = _pool(gen, dev, n, 50, torch.bfloat16 if bf16 else torch.float32)
                w = torch.randn(50, generator=gen, device=dev)
                cases.append((f"range N={n}", lambda x=x, y=y, w=w, n=n, **kw:
                              logit_loglik.logit_delta(x, y, w, w + 0.01, idx=range(3, n), **kw)))
        if not bf16:
            x, y = _pool(gen, dev, 12214, 50, torch.float32)
            w = torch.randn(32, 50, generator=gen, device=dev)
            idx = torch.randint(0, 12214, (32, 100), generator=gen, device=dev, dtype=torch.int32)
            cases.append(("fp32 rows rounded in the kernel", lambda **kw:
                          batched_loglik.gather_and_delta(x, y, idx, w, w + 0.05, round_bf16=True,
                                                          **kw)))
    elif family == "gaussian_ar1":
        dtype = torch.bfloat16 if bf16 else torch.float32
        for k, m, n in ((1, 1, 1000), (1, 100, 1000), (32, 100, 1000), (32, 100, 100_000),
                        (33, 37, 129), (32, 400, 1000)):
            par = [torch.rand(k, generator=gen, device=dev) * 0.5 + 0.5,
                   torch.rand(k, generator=gen, device=dev) + 0.01,
                   torch.rand(k, generator=gen, device=dev) * 0.5 + 0.5,
                   torch.rand(k, generator=gen, device=dev) + 0.01]
            xt = torch.randn(k, n, generator=gen, device=dev).to(dtype)
            xp = torch.randn(k, n, generator=gen, device=dev).to(dtype)
            idx = torch.randint(0, n, (k, m), generator=gen, device=dev, dtype=torch.int32)
            cases.append((f"K={k} m={m} of N={n}", lambda xt=xt, xp=xp, i=idx, par=par, **kw:
                          gaussian_ar1.gather_ar1_delta(xt, xp, i, *par, **kw)))
            cases.append((f"K={k} m={m} shared", lambda xt=xt, xp=xp, i=idx, par=par, **kw:
                          gaussian_ar1.gather_ar1_delta(xt[0].contiguous(), xp[0].contiguous(),
                                                        i, *par, **kw)))
            cases.append((f"K={k} m={m} gathered", lambda xt=xt, xp=xp, i=idx, par=par, **kw:
                          gaussian_ar1.batched_gaussian_ar1_delta(
                              torch.gather(xt, 1, i.long()), torch.gather(xp, 1, i.long()),
                              *par, **kw)))
        for n in (1000, 100_000):  # G's exact passes
            xt = torch.randn(n, generator=gen, device=dev).to(dtype)
            par1 = [torch.rand(1, generator=gen, device=dev) + 0.5 for _ in range(4)]
            cases.append((f"range N={n}", lambda xt=xt, par=par1, n=n, **kw:
                          gaussian_ar1.gather_ar1_delta(xt, xt * 0.5, range(1, n), *par, **kw)))
        if not bf16:
            xt = torch.randn(32, 1000, generator=gen, device=dev)
            idx = torch.randint(0, 1000, (32, 100), generator=gen, device=dev, dtype=torch.int32)
            par = [torch.rand(32, generator=gen, device=dev) + 0.5 for _ in range(4)]
            cases.append(("fp32 pools rounded in the kernel", lambda **kw:
                          gaussian_ar1.gather_ar1_delta(xt, xt * 0.9, idx, *par, round_bf16=True,
                                                        **kw)))
    else:  # the CE families
        hdt = torch.bfloat16
        tdt = torch.bfloat16 if bf16 else torch.float32
        for k, m, d, v in ((1, 100, 4096, 65024), (1, 37, 64, 1000), (1, 1, 128, 300),
                           (8, 100, 4096, 65024), (3, 37, 64, 1000)):
            if (k == 1) != (family == "fused_ce"):
                continue
            n = 8128 if d == 4096 else 500
            h = torch.randn(n, d, generator=gen, device=dev).to(hdt)
            table = (0.02 * torch.randn(v, d, generator=gen, device=dev)).to(tdt)
            tg = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
            idx = torch.randint(0, n, (k, m), generator=gen, device=dev, dtype=torch.int32)
            label = f"K={k} m={m} D={d} V={v}"
            if family == "fused_ce":
                cases.append((label, lambda h=h, t=table, tg=tg, i=idx, **kw:
                              fused_ce.fused_ce(h, t, tg, idx=i[0], **kw)))
                cases.append((label + " fp32 h", lambda h=h, t=table, tg=tg, i=idx, **kw:
                              fused_ce.fused_ce(h.float(), t, tg, idx=i[0], **kw)))
                if not bf16:
                    cases.append((label + " rounded", lambda h=h, t=table, tg=tg, i=idx, **kw:
                                  fused_ce.fused_ce(h.float(), t, tg, idx=i[0], round_bf16=True,
                                                    **kw)))
            else:
                cases.append((label, lambda h=h, t=table, tg=tg, i=idx, **kw:
                              fused_ce.gather_fused_ce(h, tg, i, t, **kw)))
                if d == 64:  # per-chain tables (J's form) at the small width
                    tables = (0.02 * torch.randn(k, v, d, generator=gen, device=dev)).to(tdt)
                    hb = torch.randn(k, m, d, generator=gen, device=dev).to(hdt)
                    tb = torch.randint(0, v, (k, m), generator=gen, device=dev, dtype=torch.int32)
                    cases.append((label + " per-chain", lambda hb=hb, t=tables, tb=tb, **kw:
                                  fused_ce.batched_fused_ce(hb, t, tb, **kw)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("family", ["logit_delta", "batched_loglik", "gaussian_ar1", "fused_ce",
                                    "batched_fused_ce"])
def test_tuned_candidates_bit_for_bit(family, prec, cuda_device):
    """The bit rule on the card: every candidate of the family's grid gives
    the default launch's bits, at the main path's shapes and ragged ones
    (m = 1, 37, 100, 400; D = 3, 50; pools off the 16-byte boundary; a V
    that is not a multiple of the 128-row tile; the contiguous passes)."""
    from repro_torch.kernels import autotune

    default = autotune.DEFAULT_TILES[family]
    for label, run in _tuned_cases(family, prec, cuda_device):
        want = run(**default)
        for cand in autotune.CANDIDATES[family]:
            assert _same_bits(run(**cand), want), (label, cand)


@pytest.mark.cuda
def test_tuned_dispatch_equals_default_dispatch(cuda_device, monkeypatch, tmp_path):
    """``ops`` with the tuner forced on (a fresh cache: each bucket of the
    three delta families raced on first use; the CE families' grids are one)
    equals ``mode="always"`` with the defaults pinned, bit for bit, one
    counted launch a call; the races' launches count apart."""
    from repro_torch.kernels import autotune

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, y = _pool(gen, cuda_device, 12214, 50, torch.float32)
    w = torch.randn(32, 50, generator=gen, device=cuda_device)
    idx = torch.randint(0, 12214, (32, 100), generator=gen, device=cuda_device, dtype=torch.int32)
    xt = torch.randn(32, 1000, generator=gen, device=cuda_device)
    par = [torch.rand(32, generator=gen, device=cuda_device) + 0.5 for _ in range(4)]
    h = torch.randn(2000, 256, generator=gen, device=cuda_device).to(torch.bfloat16)
    table = 0.02 * torch.randn(3000, 256, generator=gen, device=cuda_device)
    tg = torch.randint(0, 3000, (2000,), generator=gen, device=cuda_device, dtype=torch.int32)
    calls = {
        "batched_logit_delta": lambda: ops.gather_and_delta(x, y, idx, w, w + 0.05, mode="always"),
        "logit_delta": lambda: ops.logit_delta(x, y, w[0], w[1], idx=idx[0], mode="always"),
        "gaussian_ar1_delta": lambda: ops.gather_ar1_delta(xt, xt * 0.9, idx % 1000, *par,
                                                           mode="always"),
        "fused_ce": lambda: ops.fused_ce(h, table, tg, idx=idx[0] % 2000, mode="always"),
        "batched_fused_ce": lambda: ops.gather_fused_ce(h, tg, idx[:4] % 2000, table,
                                                        mode="always"),
    }
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    want = {name: call() for name, call in calls.items()}
    monkeypatch.setenv(autotune.ENV_VAR, "1")
    monkeypatch.setenv(autotune.DIR_ENV_VAR, str(tmp_path))
    autotune.clear_cache(memory_only=True)
    races, raced = autotune.race_stats["races"], sum(autotune.race_launches.values())
    try:
        for name, call in calls.items():
            ops.reset_launches()
            assert _same_bits(call(), want[name]), name
            assert dict(ops.launches) == {name: 1}, (name, dict(ops.launches))
    finally:
        autotune.clear_cache(memory_only=True)
    assert autotune.race_stats["races"] == races + 3
    assert sum(autotune.race_launches.values()) > raced


@pytest.mark.cuda
def test_warm_writes_the_card_json(cuda_device, monkeypatch, tmp_path):
    """``warm()`` races the representative buckets of the three families
    with a grid to race and writes ``<card>.json``: every entry bit for bit,
    a winner from the grid, the default's time beside it, the kernel
    sources' hash."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv(autotune.ENV_VAR, "1")
    monkeypatch.setenv(autotune.DIR_ENV_VAR, str(tmp_path))
    autotune.clear_cache(memory_only=True)
    try:
        out = autotune.warm()
    finally:
        autotune.clear_cache(memory_only=True)
    card = autotune.card_name(cuda_device)
    assert card.startswith(torch.cuda.get_device_name(0)) and " sm_" in card
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    entries = json.loads((tmp_path / files[0]).read_text())
    assert set(entries) == set(out) and len(entries) == 3
    for key, entry in entries.items():
        family = key.split("|")[1]
        assert entry["bitwise"] and entry["tiles"] in list(autotune.CANDIDATES[family])
        assert entry["sources"] == autotune._sources()
        assert entry["candidates"] == len(autotune.CANDIDATES[family])
        assert 0 < entry["us"] <= entry["default_us"]


@pytest.mark.cuda
def test_wall_clock_step_stats_synchronizes(cuda_device):
    """A step that queues ~20 ms of sleep on the card returns at once on the
    host; the timer waits for it."""
    from repro_torch.runtime import wall_clock_step_stats

    def step():
        out = torch.zeros(1, device=cuda_device)
        torch.cuda._sleep(40_000_000)  # >= 20 ms at <= 2 GHz
        return {"out": out.add_(1)}

    t0 = time.perf_counter()
    step()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    stats = wall_clock_step_stats(step, (), n=3)
    assert host_s < 0.015 <= stats["min_s"] <= stats["mean_s"]


# ---------------------------------------------------------------------------
# The LM's sharded parameters on four slots of the card
# ---------------------------------------------------------------------------


def _card_mesh(model, physical=1):
    from repro_torch.distributed import force_devices
    from repro_torch.launch.mesh import make_mesh_for_devices

    with force_devices(4, physical=physical):
        return make_mesh_for_devices(4, model_parallel=model)


def _four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("one slot a card needs four cards; this machine has "
                    f"{torch.cuda.device_count()}")


@pytest.mark.cuda
@pytest.mark.parametrize("model", [2, 4])
def test_sharded_lm_step_on_card_slots(cuda_device, model):
    """The plain and cached train steps on parameters sharded over four
    slots of the card ((2, 2) and (1, 4)), the round op on every round:
    every info field, the cache and every parameter equal the unsharded
    steps' bit for bit, with proposals accepted and rejected."""
    _check_sharded_lm_step(cuda_device, model, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [2, 4])
def test_sharded_lm_step_on_four_cards(cuda_device, model):
    """H-mp's check with one slot a card: the test above over four cards,
    the pieces on cuda:0..3 and the compute on cuda:0. Skips on fewer."""
    _four_cards()
    _check_sharded_lm_step(cuda_device, model, 4)


def _check_sharded_lm_step(cuda_device, model, physical):
    from repro_torch.bayes import (LogLikCache, TrainConfig, make_cached_train_step,
                                   make_train_step)
    from repro_torch.distributed import gather_params, logical_axis_rules, shard_params
    from repro_torch.models import param_specs

    cfg, params, batch = _lm_case(cuda_device)
    tc = TrainConfig(round_batch=2, epsilon=0.2, sigma=1e-3)
    mesh = _card_mesh(model, physical)

    def chain(step, theta, cached):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        cache = LogLikCache.empty(8, device=cuda_device)
        infos = []
        for _ in range(8):
            if cached:
                theta, cache, info = step(gen, theta, batch, cache)
            else:
                theta, info = step(gen, theta, batch)
            infos.append(info)
        return theta, infos, cache

    for maker, cached in ((make_train_step, False), (make_cached_train_step, True)):
        step = maker(cfg, tc)
        want, want_infos, want_cache = chain(step, params, cached)
        ops.reset_launches()
        with logical_axis_rules(mesh):
            got, infos, cache = chain(step, shard_params(params, mesh, specs=param_specs(cfg)),
                                      cached)
        torch.cuda.synchronize()
        assert ops.launches["t_test_round"] > 0
        assert 0 < sum(int(i.accepted) for i in want_infos) < 8
        for a, b in zip(infos, want_infos):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert torch.equal(cache.ll, want_cache.ll) and torch.equal(cache.valid, want_cache.valid)
        for a, b in zip(_leaves(gather_params(got)), _leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_lm_decode_on_card_slots(cuda_device):
    """Prefill and 8 decode steps from parameters sharded over a (2, 2)
    mesh of card slots: every logit and cache leaf equal the unsharded
    run's bit for bit, at reduced width (bf16 GEMMs on gathered layers that
    keep the unsharded views' address modulo 64 bytes)."""
    from repro_torch.distributed import logical_axis_rules, shard_params
    from repro_torch.models import decode_step, param_specs, prefill

    cfg, params, batch = _lm_case(cuda_device)
    prompts = batch["tokens"][:4, :12]
    mesh = _card_mesh(2)

    def run(p):
        cache, logits = prefill(p, prompts, cfg, 24)
        out = [logits]
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for _ in range(8):
            cache, logits = decode_step(p, cache, tok, cfg)
            out.append(logits)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return cache, out

    want_cache, want = run(params)
    with logical_axis_rules(mesh):
        cache, got = run(shard_params(params, mesh, specs=param_specs(cfg)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), _leaves(want_cache)))


_INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _bits(t):
    from repro_torch.distributed import ShardedTensor

    t = t.gather() if isinstance(t, ShardedTensor) else t
    return t.contiguous().view(_INT_VIEW[t.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("model", [2, 4])
def test_sharded_mala_step_on_card_slots(cuda_device, model):
    """Three MALA steps on parameters sharded over four slots of the card
    ((2, 2) and (1, 4)) against the unsharded steps from one seed: every
    gradient (returned sharded), theta', info field and final parameter
    bit for bit as integer views, at reduced width in bf16; the round op
    launched. Then one Adam step (``value_and_grad`` + ``adam_step``) the
    same way, its parameters and moments bit for bit."""
    from repro_torch.bayes import TrainConfig, mala_grads, mala_move
    from repro_torch.bayes.train import _flat_paths, subsampled_decide
    from repro_torch.core.subsampled_mh import draw_log_u
    from repro_torch.distributed import ShardedTensor, shard_params
    from repro_torch.models import param_specs
    from repro_torch.optim import adam_init, adam_step, lm_loss_fn
    from repro_torch.optim.optimizers import value_and_grad

    cfg, params, batch = _lm_case(cuda_device)
    tc = TrainConfig(round_batch=2, epsilon=0.2, proposal="mala", mala_step=2e-5)
    mesh = _card_mesh(model)
    sp = shard_params(params, mesh, specs=param_specs(cfg))
    chains = {"plain": params, "sharded": sp}
    gens = {k: torch.Generator(device=cuda_device).manual_seed(5) for k in chains}
    ops.reset_launches()
    for _ in range(3):
        out = {}
        for name, theta in chains.items():
            log_u = draw_log_u(gens[name], (), cuda_device)
            g = mala_grads(cfg, tc, theta, batch)
            theta_p = mala_move(theta, dict(g), tc, gens[name])
            new, info = subsampled_decide(cfg, tc, theta, theta_p, log_u, batch)
            out[name] = (g, _flat_paths(theta_p), info, new)
        (g0, p0, i0, n0), (g1, p1, i1, n1) = out["plain"], out["sharded"]
        assert all(isinstance(v, ShardedTensor) for v in g1.values())
        assert all(torch.equal(_bits(g0[k]), _bits(g1[k])) for k in g0)
        assert all(torch.equal(_bits(a), _bits(b)) for (_, a), (_, b) in zip(p0, p1))
        for x, y in zip(i0, i1):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                               y.view(torch.int32) if y.is_floating_point() else y)
        chains = {"plain": n0, "sharded": n1}
    torch.cuda.synchronize()
    assert ops.launches["t_test_round"] > 0
    for (_, a), (_, b) in zip(_flat_paths(chains["plain"]), _flat_paths(chains["sharded"])):
        assert torch.equal(_bits(a), _bits(b))

    vg = value_and_grad(lm_loss_fn(cfg))
    (_, g0), (_, g1) = vg(params, batch), vg(sp, batch)
    want, got = adam_step(g0, adam_init(params), params), adam_step(g1, adam_init(sp), sp)
    for tree_w, tree_g in zip((want[0], want[1].mu, want[1].nu), (got[0], got[1].mu, got[1].nu)):
        for (_, a), (_, b) in zip(_flat_paths(tree_w), _flat_paths(tree_g)):
            assert isinstance(b, ShardedTensor) and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_per_chain_logit_pools_on_card(cuda_device):
    """The ``logit`` family on per-chain (K, N, D) pools: each chain's rows
    gathered on the card, then one launch of the pair-delta kernel's
    gathered form, at K = 32, m = 100 of N = 1 000, D = 50 (phase A's case)
    and K = 33, m = 7, D = 3, against the plain version on the same rows
    (FP32_TOL) and against the shared-pool route on a pool copied per chain
    (the same rows and row sums; the bits are printed, not held)."""
    from repro_torch.core.target_builder import get_family
    from repro_torch.kernels import ref

    fam = get_family("logit")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for k, n, m, d in ((32, 1000, 100, 50), (33, 200, 7, 3)):
        x = torch.randn(k, n, d, generator=gen, device=cuda_device) / d ** 0.5
        y = torch.where(torch.rand(k, n, generator=gen, device=cuda_device) < 0.5, 1.0, -1.0)
        w = torch.randn(k, d, generator=gen, device=cuda_device)
        wp = w + 0.05 * torch.randn(k, d, generator=gen, device=cuda_device)
        idx = torch.randint(0, n, (k, m), generator=gen, device=cuda_device, dtype=torch.int32)
        kk = torch.arange(k, device=cuda_device)[:, None]
        ops.reset_launches()
        got = fam.ensemble_delta((x, y), w, wp, idx)
        torch.cuda.synchronize()
        assert dict(ops.launches) == {"batched_logit_delta": 1}
        want = ref.batched_logit_delta_ref(x[kk, idx.long()], y[kk, idx.long()], w, wp)
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL)
        shared = fam.ensemble_delta((x[0], y[0]), w, wp, idx)
        copied = fam.ensemble_delta((x[:1].expand(k, n, d).contiguous(),
                                     y[:1].expand(k, n).contiguous()), w, wp, idx)
        print(f"\nK={k} m={m} D={d}: per-chain route bit for bit the shared pool's in-kernel "
              f"gather: {torch.equal(shared.view(torch.int32), copied.view(torch.int32))}")


# ---------------------------------------------------------------------------
# Launches on another card; the ce chain mesh; the exact ensemble step; SGD
# and SGLD on the mesh; the router's lanes_per_shard
# ---------------------------------------------------------------------------

_FY_FIRST = list(_FY_CASES)[0]
_GIBBS_FIRST = list(_GIBBS_CASES)[0]
# each kernel's card-against-plain check, run on another card's tensors
_ON_CARD = {
    "logit_delta": lambda dev: test_pair_delta_kernel_matches_plain("fp32", dev),
    "batched_logit_delta": lambda dev: test_pair_delta_kernel_matches_plain("bf16", dev),
    "t_test_round": lambda dev: test_round_kernel_matches_plain("K32_m100", dev),
    "gaussian_ar1_delta": lambda dev: test_ar1_delta_kernel_matches_plain("fp32", dev),
    "fy_draw": lambda dev: test_fy_draw_kernel_matches_plain(_FY_FIRST, dev),
    "pgibbs_sweep": lambda dev: test_pgibbs_kernel_matches_plain(dev),
    "fused_ce": lambda dev: test_batched_and_gather_fused_ce_match_plain(False, dev),
    "batched_fused_ce": lambda dev: test_batched_and_gather_fused_ce_match_plain(True, dev),
    "gibbs_z_sweep": lambda dev: _check_gibbs_against_plain(_GIBBS_FIRST, dev),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(_ON_CARD))
def test_launch_on_another_card_from_this_thread(kernel, cuda_device):
    """Each of the nine kernels on cuda:1 tensors, launched from a thread
    whose current card is cuda:0: the launch goes to the tensors' card (the
    wrapper's device guard), its outputs held against the plain version as
    the kernel's own card test holds them, and the thread's current card
    is cuda:0 again after it. Skips on one card."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("a launch on another card needs two cards; this machine has one")
    other, seen, errors = torch.device("cuda", 1), [], []

    def run():
        try:
            torch.cuda.set_device(0)
            _ON_CARD[kernel](other)
            seen.extend([ops.launches[kernel], torch.cuda.current_device()])
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if errors:
        raise errors[0]
    assert seen[0] > 0 and seen[1] == 0, seen


def _small_ce(dev, k=8):
    from repro_torch.core import build_target

    gen = torch.Generator(device=dev).manual_seed(4)
    n, d, v = 600, 64, 1000
    h = torch.randn(n, d, generator=gen, device=dev)
    tokens = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    target = build_target("ce", (h, tokens), n, prior_logpdf=lambda t: -(t * t).sum((-2, -1)))
    return target, 0.05 * torch.randn(k, v, d, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("physical", [1, 4])
def test_ce_chain_mesh_on_card_slots(physical, cuda_device):
    """J-mp's check at reduced width: a K = 8 ``ce`` ensemble (per-chain
    (1 000, 64) tables, m = 100 of N = 600) with ``shard=True`` over four
    slots (on the card, and one a card over four cards) against
    ``shard=False``: samples and every info field bit for bit, the CE
    kernel launched on each slot as often a round as unsharded. Four cards
    skip on fewer."""
    from repro_torch.distributed import force_devices

    if physical > 1:
        _four_cards()
    target, theta = _small_ce(cuda_device)
    ops.reset_launches()
    want, want_infos, _, _ = _ce_ensemble_run(target, theta, False, 6, cuda_device)
    a_round = ops.launches["batched_fused_ce"] // ops.launches["t_test_round"]
    with force_devices(4, physical=physical):
        ops.reset_launches()
        got, infos, _, mesh = _ce_ensemble_run(target, theta, True, 6, cuda_device)
    assert mesh is not None and mesh.shape == {"chains": 4}
    assert torch.equal(got, want)
    for a, b in zip(infos, want_infos):
        assert torch.equal(a, b)
    per_slot = {s: n for (s, name), n in ops.slot_launches.items() if name == "batched_fused_ce"}
    assert len(per_slot) == 4 and set(per_slot.values()) == {a_round * ops.launches["t_test_round"]}


@pytest.mark.cuda
def test_exact_ensemble_step_recomputed_on_card(cuda_device):
    """C-exact at reduced size: ``ChainEnsemble(kernel="exact")`` (K = 8,
    N = 2 000, D = 10) for 6 transitions with theta' logged; each
    transition recomputed by one full-range ``logit_delta`` pass a chain
    from the logged theta, theta' and log u: the sum within 1e-4 of the sum
    of |delta| (float32 sums in two orders) and every decision equal."""
    from repro_torch.core import ChainEnsemble, RandomWalk, build_target

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    n, d, k, steps = 2000, 10, 8, 6
    x = torch.randn(n, d, generator=gen, device=cuda_device) / d ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device=cuda_device) < 0.5, 1.0, -1.0)
    target = build_target("logit", (x, y), n, prior_logpdf=lambda w: -5.0 * (w * w).sum(-1))
    log = []

    def proposal(g, theta):
        theta_p, corr = RandomWalk(0.05)(g, theta)
        log.append(theta_p.clone())
        return theta_p, corr

    ens = ChainEnsemble(target, proposal, k, kernel="exact", device=cuda_device)
    theta0 = 0.3 * torch.randn(k, d, generator=gen, device=cuda_device)
    ops.reset_launches()
    _, samples, infos = ens.run(9, ens.init(theta0, batched=True), steps)
    assert ops.launches["batched_logit_delta"] == steps
    for t in range(steps):
        theta = theta0 if t == 0 else samples[:, t - 1]
        g = target.log_global(theta, log[t])
        for c in range(k):
            delta = ops.logit_delta(x, y, theta[c], log[t][c], idx=range(0, n))
            assert float((delta.sum() - infos.mu_hat[c, t] * n).abs()) <= 1e-4 * float(
                delta.abs().sum())
            assert bool(infos.log_u[c, t] < g[c] + delta.sum()) == bool(infos.accepted[c, t])
    assert 0 < int(infos.accepted.sum()) < infos.accepted.numel()


@pytest.mark.cuda
def test_sgd_and_sgld_on_card_slots(cuda_device):
    """H-sgd at reduced width: ``sgd_step`` and ``sgld_step`` on parameters
    sharded over four slots of the card ((2, 2)) against the unsharded
    steps, from one gradient and one generator seed: every parameter bit
    for bit as integer views; SGLD moves every leaf."""
    from repro_torch.bayes.train import _flat_paths
    from repro_torch.distributed import shard_params
    from repro_torch.models import param_specs
    from repro_torch.optim import lm_loss_fn, sgd_step, sgld_step
    from repro_torch.optim.optimizers import value_and_grad

    cfg, params, batch = _lm_case(cuda_device)
    sp = shard_params(params, _card_mesh(2), specs=param_specs(cfg))
    vg = value_and_grad(lm_loss_fn(cfg))
    (_, g0), (_, g1) = vg(params, batch), vg(sp, batch)
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(7)  # noqa: E731
    for want, got in ((sgd_step(g0, params, 1e-3), sgd_step(g1, sp, 1e-3)),
                      (sgld_step(gen(), g0, params, 1e-3), sgld_step(gen(), g1, sp, 1e-3))):
        for (_, a), (_, b) in zip(_flat_paths(want), _flat_paths(got)):
            assert torch.equal(_bits(a), _bits(b))
    moved = sgld_step(gen(), g0, params, 1e-3)
    assert all(not torch.equal(a, b) for (_, a), (_, b) in zip(_flat_paths(moved),
                                                                _flat_paths(params)))


@pytest.mark.cuda
def test_router_lanes_per_shard_on_card(cuda_device):
    """R-lanes at reduced size: a three-replica fleet on the card, served
    through routers of 1, 2 and all lanes a shard: only the first N
    replicas serve, and every answer equals the writer's query on the same
    rows bit for bit."""
    from repro_torch.fleet import Fleet, FleetConfig, FleetRouter
    from repro_torch.serving import FreshnessPolicy, ServingConfig

    fleet = Fleet(FleetConfig(replicas=3, serving=ServingConfig(
        num_chains=4, refresh_steps=8, window=16, micro_batch=8, max_batch=4,
        freshness=FreshnessPolicy(max_staleness_s=1e9, min_draws=16), seed=0,
        device=cuda_device)))
    fleet.add_workload("bayeslr", n_train=2000, d=5, batch_size=100)
    try:
        fleet.warm()
        shard = fleet.shards("bayeslr")[0]
        spec = fleet.spec("bayeslr", "predictive")
        for lanes in (1, 2, None):
            router = FleetRouter(fleet, max_batch=4, default_deadline_s=30.0,
                                 lanes_per_shard=lanes)
            assert [l.replica.name for l in router._lanes["bayeslr"]] == \
                [r.name for r in shard.replicas[:lanes]]
            reqs = []
            for i in range(12):
                xs = spec.make_queries(torch.Generator().manual_seed(i), 3)
                reqs.append((xs, router.submit("bayeslr", "predictive", xs)))
            router.drain()
            for xs, req in reqs:
                want, _ = shard.writer.query(spec, xs)
                np.testing.assert_array_equal(req.result(timeout_s=30.0), np.asarray(want))
            served = [l.served for l in router._lanes["bayeslr"]]
            assert sum(served) > 0 and len(served) == (lanes or 3)
    finally:
        fleet.close()
