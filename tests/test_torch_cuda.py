"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips (the CUDA kernels have no CPU mode).
"""
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


def _round_state(rng, k, m, max_count):
    count = rng.integers(0, max_count, size=k).astype(np.float32)
    mean = rng.normal(0, 0.05, k).astype(np.float32)
    m2 = (np.maximum(count - 1, 0) * rng.uniform(0.5, 2.0, k)).astype(np.float32)
    l = (mean[:, None] + rng.standard_normal((k, m))).astype(np.float32)
    valid = rng.uniform(size=(k, m)) < 0.9
    valid[1] = False  # an empty batch keeps its state
    l[2] = 0.125  # a constant batch into an empty accumulator: s == 0
    count[2] = mean[2] = m2[2] = 0
    mu0 = rng.normal(0, 0.05, k).astype(np.float32)
    return count, mean, m2, l, valid, mu0


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


@pytest.mark.cuda
def test_round_kernel_matches_plain(cuda_device):
    """The round op: counts, rounds, done flags and decisions identical;
    mean, m2 and p-value within 1e-4 relative (the merge sums in another
    order)."""
    k, m = 32, 100
    count, mean, m2, l, valid, mu0 = _round_state(np.random.default_rng(1), k, m, 5000)
    states = []
    for mode in ("always", "never"):
        st = [torch.tensor(a, device=cuda_device) for a in (count, mean, m2)]
        rest = [torch.zeros(k, dtype=torch.int32, device=cuda_device),
                torch.zeros(k, dtype=torch.bool, device=cuda_device),
                torch.zeros(k, dtype=torch.bool, device=cuda_device),
                torch.ones(k, device=cuda_device)]
        ops.t_test_round(torch.tensor(l, device=cuda_device),
                         torch.tensor(valid, device=cuda_device), *st,
                         torch.tensor(mu0, device=cuda_device),
                         torch.full((k,), 0.05, device=cuda_device), 12214, 123, *rest,
                         mode=mode)
        states.append(st + rest)
    got, want = states
    for i in (0, 3, 4, 5):  # count, rounds, done, decision
        assert torch.equal(got[i], want[i])
    for i in (1, 2, 6):  # mean, m2, pval
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-7)


def test_cuda_dispatch_refuses_cpu_tensors():
    """The other side of the device rule, checkable anywhere: `always` on
    CPU tensors raises instead of running the plain version."""
    x = torch.zeros(4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.logit_delta(x, torch.ones(4), torch.zeros(3), torch.zeros(3), mode="always")
