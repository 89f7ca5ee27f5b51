"""The port's optimizer substrate (``repro_torch.optim``), the step timer
(``runtime.wall_clock_step_stats``), ``convert.adam_state`` and the hybrid
Adam-then-MH example (``examples/lm_train_torch.py``) against the JAX
package on numpy inputs made from a seed.

The reference's steps run op by op (as its example calls ``adam_step``);
its loss and gradients through ``jax.value_and_grad``, compiled with
``xla_allow_excess_precision`` off in bf16 (the default fused program keeps
float32 between ops where the port rounds to bf16, as in
``tests/test_torch_lm.py``).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.models import init_params as j_init
from repro.optim import adam_init as j_adam_init
from repro.optim import adam_step as j_adam_step
from repro.optim import lm_loss_fn as j_loss_fn
from repro.optim import sgd_step as j_sgd_step
from repro.optim import sgld_step as j_sgld_step
from repro_torch import convert
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig, MarkovStream
from repro_torch.models import init_params
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import AdamState, adam_init, adam_step, lm_loss_fn, sgd_step, sgld_step
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.runtime import wall_clock_step_stats

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

torch.set_num_threads(1)
SHAPES = {"w": (37, 5), "b": (5,), "blk": {"k": (3, 4, 6), "n": (64,)}}
BF16_LEAVES = ("b", "n")  # the leaves held in bfloat16; the rest float32


def _tree(rng, shapes=SHAPES, scale=1.0):
    """A numpy tree of SHAPES' leaves, bf16 where BF16_LEAVES names them."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _tree(rng, v, scale)
        else:
            a = (scale * rng.standard_normal(v)).astype(np.float32)
            out[k] = np.asarray(jnp.asarray(a, jnp.bfloat16)) if k in BF16_LEAVES else a
    return out


def _flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _flat(v, f"{prefix}/{k}" if prefix else k).items()}
    return {prefix: tree}


def _np(t):
    """A port leaf as numpy, bf16 kept as JAX's bfloat16 type."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        return t.numpy()
    return np.asarray(t)


def _ulps_bf16(a, b):
    ia = np.asarray(a).view(np.int16).astype(np.int64)
    ib = np.asarray(b).view(np.int16).astype(np.int64)
    return np.abs(ia - ib)


def test_adam_step_matches_reference():
    """Five steps from ``adam_init`` on the same gradients: float32 leaves,
    mu and nu within 1e-6 relative; bf16 leaves equal or one bf16 ulp apart
    on at most 0.1% of elements; count equal. No ``pow`` ulp shows at these
    counts (see ``test_adam_bias_correction_pow``)."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, js = jax.tree.map(jnp.asarray, p0), j_adam_init(jax.tree.map(jnp.asarray, p0))
    tp = convert.lm_params(p0, device="cpu")
    ts = adam_init(tp)
    for step in range(5):
        g = _tree(rng, scale=0.1 * (step + 1))
        jp, js = j_adam_step(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2)
        tp, ts = adam_step(convert.lm_params(g, device="cpu"), ts, tp, lr=1e-2)
        assert int(ts.count) == int(js.count) == step + 1 and ts.count.dtype == torch.int32
        for name, want in _flat(jax.tree.map(np.asarray, jp)).items():
            got = _np(_flat(tp)[name])
            if want.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                ulps = _ulps_bf16(got, want)
                assert ulps.max() <= 1 and np.mean(ulps > 0) <= 1e-3, (name, step)
        for which in ("mu", "nu"):
            wants = _flat(jax.tree.map(np.asarray, getattr(js, which)))
            gots = _flat(getattr(ts, which))
            for name, want in wants.items():
                assert gots[name].dtype == torch.float32
                np.testing.assert_allclose(gots[name].numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("b", [0.9, 0.999])
def test_adam_bias_correction_pow(b):
    """Where the one known ulp shows: float32 ``b ** c`` in PyTorch and XLA
    differ by one ulp at a few counts (for 0.9 first at 31, for 0.999 at
    168; XLA flushes the subnormal tail to zero, PyTorch keeps it). In the
    bias correction ``1 - b ** c`` the cancellation makes that up to 4 ulps
    of the difference (0.999), at most 4e-7 of it relative at every count up
    to 2 000: a step's v / (1 - b2^c) moves by that, its square root by half,
    far below an ulp of a leaf."""
    c = np.arange(1, 2001, dtype=np.float32)
    jpow = np.asarray(b ** jnp.asarray(c))
    tpow = (b ** torch.tensor(c)).numpy()
    normal = jpow > np.finfo(np.float32).tiny
    assert np.abs(jpow.view(np.int32) - tpow.view(np.int32))[normal].max() <= 1
    first = int(c[np.nonzero(jpow != tpow)[0][0]])
    assert first > 5  # the five-step test above sees none
    jc = np.asarray(1 - b ** jnp.asarray(c))
    tc = (1 - b ** torch.tensor(c)).numpy()
    assert np.abs(jc.view(np.int32) - tc.view(np.int32)).max() <= 4
    np.testing.assert_allclose(tc, jc, rtol=4e-7, atol=0)


def test_sgd_step_bit_for_bit():
    rng = np.random.default_rng(1)
    p, g = _tree(rng), _tree(rng)
    want = _flat(jax.tree.map(np.asarray, j_sgd_step(jax.tree.map(jnp.asarray, g),
                                                     jax.tree.map(jnp.asarray, p), lr=0.05)))
    got = _flat(sgd_step(convert.lm_params(g, device="cpu"), convert.lm_params(p, device="cpu"),
                         lr=0.05))
    for name, w in want.items():
        assert np.array_equal(_np(got[name]).view(np.uint8), w.view(np.uint8)), name


def test_sgld_temperature_zero_bit_for_bit():
    """At temperature 0 the noise term is zero: p + lr g, bit for bit the
    reference's."""
    rng = np.random.default_rng(2)
    p, g = _tree(rng), _tree(rng)
    want = _flat(jax.tree.map(np.asarray, j_sgld_step(
        jax.random.key(0), jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, p),
        lr=0.05, temperature=0.0)))
    tp, tg = convert.lm_params(p, device="cpu"), convert.lm_params(g, device="cpu")
    got = _flat(sgld_step(torch.Generator().manual_seed(0), tg, tp, lr=0.05, temperature=0.0))
    plain = _flat(sgd_step({k: -v for k, v in _flat(tg).items()},
                           {k: v for k, v in _flat(tp).items()}, lr=0.05))
    for name, w in want.items():
        assert np.array_equal(_np(got[name]).view(np.uint8), w.view(np.uint8)), name
        assert torch.equal(got[name], plain[name]), name


def test_sgld_noise_moments():
    """At temperature 1 each leaf's noise (new - p - lr g) has mean within 4
    standard errors of 0 and variance within 4 of 2 lr T; two leaves' noises
    are uncorrelated (within 4 / sqrt(n))."""
    n, lr, temp = 200_000, 1e-2, 1.0
    p = {"a": torch.zeros(n), "b": torch.ones(n)}
    g = {"a": torch.full((n,), 0.5), "b": torch.full((n,), -0.25)}
    out = sgld_step(torch.Generator().manual_seed(3), g, p, lr=lr, temperature=temp)
    var = 2 * lr * temp
    noise = {}
    for k in p:
        e = (out[k].double() - (p[k].double() + lr * g[k].double()))
        noise[k] = e
        assert abs(float(e.mean())) <= 4 * np.sqrt(var / n), k
        assert abs(float(e.var()) - var) <= 4 * var * np.sqrt(2 / n), k
    corr = float(torch.corrcoef(torch.stack([noise["a"], noise["b"]]))[0, 1])
    assert abs(corr) <= 4 / np.sqrt(n)
    again = sgld_step(torch.Generator().manual_seed(3), g, p, lr=lr, temperature=temp)
    assert all(torch.equal(out[k], again[k]) for k in p)  # one generator, one draw order


def _lm_case(prec):
    jcfg, cfg = j_reduce(J_ARCHS["chatglm3-6b"]), reduce_config(ARCHS["chatglm3-6b"])
    dtype = jnp.float32 if prec == "fp32" else jnp.bfloat16
    jp = jax.tree.map(lambda a: a.astype(dtype), j_init(jax.random.key(0), jcfg))
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    mask = np.ones_like(tok)
    mask[2, 11:] = 0  # a padded tail: the mean runs over mask[:, 1:]
    return jcfg, cfg, jp, tok, mask


@pytest.mark.parametrize("prec,loss_rtol,grad_rel", [("fp32", 1e-5, 1e-4),
                                                    ("bf16", 2e-2, 2e-2)])
def test_lm_loss_and_grads_match_reference(prec, loss_rtol, grad_rel):
    """``lm_loss_fn``'s loss and autograd gradients against
    ``jax.value_and_grad`` of the reference's at ``reduce_config
    (chatglm3-6b)``: the loss within ``loss_rtol`` relative, each gradient
    leaf within ``grad_rel`` of its RMS in RMS difference."""
    jcfg, cfg, jp, tok, mask = _lm_case(prec)
    jbatch = {"tokens": jnp.asarray(tok), "mask": jnp.asarray(mask)}
    vg = jax.value_and_grad(j_loss_fn(jcfg))
    if prec == "bf16":
        jl, jg = jax.jit(vg).lower(jp, jbatch).compile(
            compiler_options={"xla_allow_excess_precision": False})(jp, jbatch)
    else:
        jl, jg = vg(jp, jbatch)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    tl, tg = value_and_grad(lm_loss_fn(cfg))(
        tp, {"tokens": torch.tensor(tok), "mask": torch.tensor(mask)})
    assert tl.dtype == torch.float32 and tl.ndim == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
    want = _flat(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jg))
    got = _flat(tg)
    assert set(want) == set(got)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    for name, w in want.items():
        gt = got[name]
        assert gt.dtype == _flat(tp)[name].dtype, name
        assert rms(gt.float().numpy() - w) <= grad_rel * rms(w), name


def test_adam_lowers_lm_loss():
    """The reference's criterion (``tests/test_substrates.py``): Adam lowers
    the mean loss per token by at least 0.1, here on a 2-layer, d 64 model in
    40 steps of the port."""
    cfg = ModelConfig(name="adam-t", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv=2, d_ff=128, vocab=128, max_seq=64)
    params = init_params(0, cfg, device="cpu")
    stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0),
                          concentration=0.15, device="cpu")
    vg = value_and_grad(lm_loss_fn(cfg))
    state = adam_init(params)
    losses = []
    for i in range(40):
        loss, grads = vg(params, stream.batch(i))
        params, state = adam_step(grads, state, params, lr=5e-3)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.1, losses
    assert int(state.count) == 40


def test_convert_adam_state_round_trip():
    """A reference ``AdamState`` after two steps carried across by
    ``convert.adam_state``: its leaves bit for bit, and a third step from it
    in both packages within the Adam test's tolerances."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    jp, js = jax.tree.map(jnp.asarray, p0), j_adam_init(jax.tree.map(jnp.asarray, p0))
    for _ in range(2):
        jp, js = j_adam_step(jax.tree.map(jnp.asarray, _tree(rng)), js, jp, lr=1e-2)
    ts = convert.adam_state(jax.tree.map(np.asarray, js), device="cpu")
    assert isinstance(ts, AdamState) and int(ts.count) == 2 and ts.count.dtype == torch.int32
    for which in ("mu", "nu"):
        want = _flat(jax.tree.map(np.asarray, getattr(js, which)))
        got = _flat(getattr(ts, which))
        for name, w in want.items():
            assert np.array_equal(got[name].numpy(), w), (which, name)
    g = _tree(rng)
    jp2, js2 = j_adam_step(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2)
    tp2, ts2 = adam_step(convert.lm_params(g, device="cpu"), ts,
                         convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu"), lr=1e-2)
    assert int(ts2.count) == int(js2.count) == 3
    for name, w in _flat(jax.tree.map(np.asarray, js2.mu)).items():
        np.testing.assert_allclose(_flat(ts2.mu)[name].numpy(), w, rtol=1e-6)
    for name, w in _flat(jax.tree.map(np.asarray, jp2)).items():
        if w.dtype == np.float32:
            np.testing.assert_allclose(_np(_flat(tp2)[name]), w, rtol=1e-6)
        else:
            assert _ulps_bf16(_np(_flat(tp2)[name]), w).max() <= 1


def test_wall_clock_step_stats():
    """One warm call, then n timed calls: the reference's keys, min <= mean."""
    calls = []

    def step(a, b):
        calls.append(1)
        return {"out": a @ b}

    a = torch.randn(16, 16)
    stats = wall_clock_step_stats(step, (a, a), n=4)
    assert set(stats) == {"mean_s", "min_s"}
    assert 0 <= stats["min_s"] <= stats["mean_s"]
    assert len(calls) == 5


def test_lm_train_example_runs_on_cpu():
    """``examples/lm_train_torch.run`` at a tiny size with ``device="cpu"``:
    both phases run, the loss is finite, sections per transition stay within
    the pool, exact MH reads the whole pool, and each phase-2 pass equals
    its twin from the same seed bit for bit."""
    import lm_train_torch as ex

    cfg = ModelConfig(name="ex-t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                      d_ff=64, vocab=64, max_seq=32)
    out = ex.run(cfg, steps=6, mh_steps=4, batch=8, seq=12, device="cpu", log=lambda *_: None)
    assert [s for s, _ in out["losses"]] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(l) for _, l in out["losses"])
    assert int(out["opt"].count) == 6
    for name, r in out["mh"].items():
        assert r["passes_equal"] and r["params_finite"], name
        assert 0 < r["sections_per_transition"] <= 8
        assert 0.0 <= r["acceptance"] <= 1.0
    assert out["mh"]["exact"]["n_evaluated"] == [8] * 4
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.run(cfg, steps=1, mh_steps=1, batch=8, seq=12, log=lambda *_: None)
