"""Gradients over the LM's sharded parameters: MALA and the optimizers on a
forced 2 x 2 mesh of CPU slots (``force_devices(4)``), held to the
unsharded port bit for bit, and the sharded gradient to the reference's.

Autograd sees each gather of a sharded leaf
(``repro_torch.distributed.GradTape``): a read's row gradient is written
into the leaf's own pieces, the contributions added in the order the
unsharded backward adds them. Bits are compared as integer views
(``int16`` for bf16, ``int32`` for float32), so a zero's sign counts.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.models import forward_loglik as j_loglik
from repro.models import init_params as j_init
from repro_torch import convert
from repro_torch._device import row_chunks, tree_leaves, tree_map
from repro_torch.bayes import TrainConfig, mala_grads, mala_move
from repro_torch.bayes.train import _flat_paths, subsampled_decide
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.core.subsampled_mh import draw_log_u
from repro_torch.data import DataConfig, MarkovStream
from repro_torch.distributed import (GradTape, ShardedTensor, force_devices, named_sharding,
                                     shard_params, whole)
from repro_torch.distributed.sharding import iter_rows, map_rows
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.models import init_params, param_specs
from repro_torch.optim import adam_init, adam_step, lm_loss_fn, sgd_step, sgld_step
from repro_torch.optim.optimizers import value_and_grad

torch.set_num_threads(1)
ARCH = "chatglm3-6b"
_INT = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def _bits(t) -> torch.Tensor:
    t = t.gather() if isinstance(t, ShardedTensor) else t
    return t.contiguous().view(_INT[t.dtype])


def _same_bits(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _mesh():
    return make_mesh_for_devices(4, model_parallel=2, device="cpu")


def _case(dtype=None):
    cfg = reduce_config(ARCHS[ARCH])
    params = init_params(0, cfg, device="cpu")
    if dtype is not None:
        params = _cast(params, dtype)
    batch = MarkovStream(DataConfig(cfg.vocab, 16, 8, seed=0), device="cpu").batch(0)
    return cfg, params, batch


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


# ---------------------------------------------------------------------------
# the sink: contributions and zeros' signs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [1, 3])
def test_grad_sink_adds_as_unsharded_autograd(layers):
    """A stacked leaf read one row a layer and a top-level leaf read twice
    (as tied embeddings are) and one read once, under gradients full of
    -0.0: every gradient bit equals the unsharded backward's, where a row
    that another read did not touch turns -0 into +0 (two or more layers)
    and a leaf read whole by every read keeps its -0."""
    rng = np.random.default_rng(layers)
    stack = torch.tensor(rng.standard_normal((layers, 4, 6)).astype(np.float32))
    table = torch.tensor(rng.standard_normal((8, 6)).astype(np.float32))
    norm = torch.tensor(rng.standard_normal(6).astype(np.float32))
    signs = torch.tensor([1.0, -1.0, 0.0, 2.0, -0.0, -3.0])

    def loss(p):
        h = torch.ones(6)
        for i in range(layers):
            h = h + (p["stack"][i] * signs).sum(0) * 0.0  # row grads of +-0
        t = whole(p["table"])
        h = h * (t * signs).sum(0)
        h = h + (whole(p["table"]) * -signs * 0.0).sum(0)
        return (h * whole(p["norm"]) * signs).sum()

    params = {"norm": norm, "stack": stack, "table": table}
    want = value_and_grad(loss)(params)[1]
    assert any(bool(torch.signbit(g[g == 0]).any()) for g in want.values())
    with force_devices(4):
        mesh = _mesh()
        names = {"norm": ("mlp",), "stack": ("layers", "embed", "mlp"), "table": ("embed", "mlp")}
        sp = {k: ShardedTensor.from_tensor(v, named_sharding(mesh, v.shape, names[k]))
              for k, v in params.items()}
        got = value_and_grad(loss)(sp)[1]
    assert all(isinstance(g, ShardedTensor) for g in got.values())
    for k in params:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def test_tape_watches_plain_and_sharded_leaves():
    """A tree of plain and sharded leaves: plain gradients are autograd's
    tensors, sharded ones sinks holding the same values; a leaf not read
    gives None (plain) or zeros (sharded)."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((4, 6)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((4, 6)).astype(np.float32))
    with force_devices(4):
        sb = ShardedTensor.from_tensor(b, named_sharding(_mesh(), b.shape, ("embed", "mlp")))
        tape = GradTape()
        wa, wb, wc = tape.watch(a), tape.watch(sb), tape.watch(b.clone())
        with torch.enable_grad():
            ga, gb, gc = tape.grad((wa * whole(wb)).sum() + (wb[1] ** 2).sum(),
                                   allow_unused=True)
        unread = tape.watch(sb)  # a sink no read reached
    assert torch.equal(ga, b) and gc is None
    want = a.clone()
    want[1] += 2 * b[1]
    assert torch.equal(gb.finish(1 << 26).gather(), want)
    assert torch.equal(unread.sink.finish(1 << 26).gather(), torch.zeros_like(b))


@pytest.mark.parametrize("max_elems", [7, 40, 1 << 26])
def test_map_rows_chunks_plain_and_sharded_alike(max_elems):
    """``map_rows`` over a plain and a sharded (6, 4, 5) leaf in chunks of
    at most ``max_elems`` elements (6 one-row chunks, 3 of two rows, one):
    the chunks are ``row_chunks``', the outputs of a multiply-add in two
    dtypes equal bit for bit, the sharded ones of the leaf's layout; an
    ``out`` updated in place stays the same tensor."""
    rng = np.random.default_rng(max_elems)
    x = torch.tensor(rng.standard_normal((6, 4, 5)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((6, 4, 5)).astype(np.float32))

    def fn(a, b):
        return torch.add(a, b, alpha=0.3), (a * b).to(torch.bfloat16)

    want = [c.shape for c in row_chunks(x, max_elems)]
    plain = map_rows(fn, [x, y], max_elems=max_elems)
    assert [c.shape for c in iter_rows(x, max_elems)] == want
    with force_devices(4):
        sh = named_sharding(_mesh(), x.shape, ("layers", "embed", "mlp"))
        sx, sy = ShardedTensor.from_tensor(x, sh), ShardedTensor.from_tensor(y, sh)
        assert [c.shape for c in iter_rows(sx, max_elems)] == want
        got = map_rows(fn, [sx, sy], max_elems=max_elems)
        assert all(isinstance(t, ShardedTensor) and t.sharding == sh for t in got)
        assert [t.dtype for t in got] == [torch.float32, torch.bfloat16]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(plain, got))
        cast = map_rows(lambda a: a * 3, [sx], dtypes=torch.bfloat16, max_elems=max_elems)
        assert torch.equal(_bits(cast), _bits((x * 3).to(torch.bfloat16)))
    z = y.clone()
    assert map_rows(lambda a, b: b.add_(a), [x, z], out=z, max_elems=max_elems) is z
    assert torch.equal(z, y + x)


@pytest.mark.parametrize("entered", [True, False], ids=["tape", "no_hooks"])
def test_tape_keeps_no_gathered_rows_for_the_backward(entered):
    """The forward of ``lm_loss_fn`` over sharded bf16 parameters under
    ``with tape:`` ends with every gathered tensor freed (autograd keeps
    leaf and rows, not the rows); the backward gathers them again and the
    gradient is the unsharded one bit for bit. Without the hooks the
    forward's gathers stay alive until the backward (the control)."""
    cfg, params, batch = _case()
    want = value_and_grad(lm_loss_fn(cfg))(params, batch)[1]
    with force_devices(4):
        sp = shard_params(params, _mesh(), specs=param_specs(cfg))
        tape = GradTape()
        tree = tree_map(tape.watch, sp)
        with torch.enable_grad():
            if entered:
                with tape:
                    value = lm_loss_fn(cfg)(tree, batch)
            else:
                value = lm_loss_fn(cfg)(tree, batch)
            gc.collect()
            recs = list(tape._outputs.values())
            alive = sum(rec.out() is not None for rec in recs)
            sinks = tape.grad(value)
        regathered = sum(rec.again is not None for rec in recs)
    assert len(sinks) == len(tree_leaves(want)) and len(recs) > 0
    if entered:
        assert alive == 0 and regathered > 0
        for s, w in zip(sinks, tree_leaves(want)):
            assert torch.equal(_bits(s.finish()), _bits(w))
    else:
        assert alive > 0 and regathered == 0
    # reference counts alone free the tape and the gradients (no cycle)
    piece = weakref.ref(sinks[0].grad.pieces[0])
    gc.disable()
    try:
        del tape, tree, value, sinks, recs
        assert piece() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# MALA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, torch.float32], ids=["bf16", "fp32"])
def test_mala_steps_equal_unsharded(dtype):
    """Three MALA steps on reduced chatglm3-6b, sharded over (2, 2) and not,
    from generators of one seed: each step's gradient, theta' and info,
    and the chain's parameters, bit for bit; the gradients and theta' come
    back sharded with the leaves' layouts."""
    cfg, params, batch = _case(dtype)
    tc = TrainConfig(round_batch=4, epsilon=0.05, proposal="mala", mala_step=2e-5)
    with force_devices(4):
        sp = shard_params(params, _mesh(), specs=param_specs(cfg))
        chains = {"plain": params, "sharded": sp}
        gens = {k: torch.Generator().manual_seed(7) for k in chains}
        accepted = []
        for _ in range(3):
            out = {}
            for name, theta in chains.items():
                log_u = draw_log_u(gens[name], (), torch.device("cpu"))
                g = mala_grads(cfg, tc, theta, batch)
                theta_p = mala_move(theta, dict(g), tc, gens[name])
                new, info = subsampled_decide(cfg, tc, theta, theta_p, log_u, batch)
                out[name] = (g, theta_p, info, new)
            (g0, p0, i0, n0), (g1, p1, i1, n1) = out["plain"], out["sharded"]
            assert list(g0) == list(g1)
            assert all(isinstance(v, ShardedTensor) for v in g1.values())
            assert all(g1[k].sharding == l.sharding for k, l in _flat_paths(sp))
            assert all(torch.equal(_bits(g0[k]), _bits(g1[k])) for k in g0)
            assert _same_bits(p0, p1)
            assert all(torch.equal(a, b) for a, b in zip(i0, i1))
            chains = {"plain": n0, "sharded": n1}
            accepted.append(bool(i0.accepted))
        assert _same_bits(chains["plain"], chains["sharded"])
    assert any(accepted)


def test_sharded_gradient_matches_reference():
    """float32: the sharded gradient against the reference's MALA gradient
    as its ``make_train_step(proposal="mala")`` takes it (``jax.grad`` of
    the first round_batch rows' log-likelihood times N / rb minus the
    prior's 0.5 sum(theta^2) / prior_var; ``src/repro/bayes/train.py:134``)
    on the same converted parameters: every leaf within 2e-4 of its own
    largest component, as the unsharded port is held
    (``tests/test_torch_lm.py::test_mala_gradient_matches_jax_grad``)."""
    jcfg = j_reduce(J_ARCHS[ARCH])
    cfg = reduce_config(ARCHS[ARCH])
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), j_init(jax.random.key(0), jcfg))
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (16, 16)).astype(np.int32)
    rb, n = 4, 16

    def logpost_est(t):
        ll = j_loglik(t, {"tokens": jnp.asarray(tok[:rb])}, jcfg, ce_chunk=256).sum() * (n / rb)
        pr = sum(jnp.sum(jnp.square(l.astype(jnp.float32))) for l in jax.tree.leaves(t))
        return ll - 0.5 * pr / 1.0

    flat = {}

    def walk(t, p=""):
        for k, v in t.items():
            q = f"{p}/{k}" if p else k
            walk(v, q) if isinstance(v, dict) else flat.__setitem__(q, np.asarray(v))

    walk(jax.grad(logpost_est)(jp))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    with force_devices(4):
        sp = shard_params(tp, _mesh(), specs=param_specs(cfg))
        got = mala_grads(cfg, TrainConfig(round_batch=4, proposal="mala"), sp,
                         {"tokens": torch.tensor(tok)})
    assert sorted(got) == sorted(flat)
    for path, g in got.items():
        w = flat[path]
        g = g.gather().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max(), path


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------


def test_value_and_grad_and_adam_equal_unsharded():
    """Three Adam steps (``value_and_grad(lm_loss_fn)`` then ``adam_step``)
    on reduced chatglm3-6b in bf16, sharded over (2, 2) and not: every loss,
    gradient, moment and parameter bit for bit, the sharded ones sharded;
    then ``sgd_step`` and ``sgld_step`` (one seed) likewise."""
    cfg, params, batch = _case()
    vg = value_and_grad(lm_loss_fn(cfg))
    with force_devices(4):
        sp = shard_params(params, _mesh(), specs=param_specs(cfg))
        p0, o0, p1, o1 = params, adam_init(params), sp, adam_init(sp)
        for _ in range(3):
            l0, g0 = vg(p0, batch)
            l1, g1 = vg(p1, batch)
            assert torch.equal(l0, l1)
            assert all(isinstance(g, ShardedTensor) for g in tree_leaves(g1))
            assert _same_bits(g0, g1)
            p0, o0 = adam_step(g0, o0, p0, lr=1e-2)
            p1, o1 = adam_step(g1, o1, p1, lr=1e-2)
            assert _same_bits(p0, p1) and _same_bits(o0.mu, o1.mu)
            assert _same_bits(o0.nu, o1.nu) and torch.equal(o0.count, o1.count)
            assert all(isinstance(t, ShardedTensor) for t in tree_leaves((p1, o1.mu, o1.nu)))
        assert float(l0) < float(vg(params, batch)[0])  # Adam lowered the loss
        assert _same_bits(sgd_step(g0, p0), sgd_step(g1, p1))
        assert _same_bits(sgld_step(torch.Generator().manual_seed(1), g0, p0, 1e-3),
                          sgld_step(torch.Generator().manual_seed(1), g1, p1, 1e-3))
