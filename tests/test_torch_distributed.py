"""The port's mesh (``repro_torch.distributed``, ``launch/mesh.py``,
``ChainEnsemble(shard=...)``, the fleet's ``mesh=`` and the front end's
``--mesh 2d --devices N``) against the JAX package.

Everything runs in this process on the CPU, with four mesh slots forced on
it (``force_devices(4)``, the counterpart of the reference's forced host
devices). The rule engine is held equal to the reference's on the same
shapes, names and mesh shapes (``resolve_spec`` reads only
``mesh.shape``); the balanced chains x data factorisation and the
validation messages equal the reference's, whose ``jax.devices()`` is
patched to n stand-ins for that. A sharded run is held to the unsharded
port bit for bit (samples and every info field), and one sharded run on the
conjugate harness to the reference's unsharded run in distribution.
"""
import contextlib
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.ensemble as j_ensemble
from repro.distributed import sharding as j_sharding
from repro_torch.core import (ChainEnsemble, RandomWalk, ScheduleConfig, SubsampledMHConfig,
                              build_target, from_iid_loglik)
from repro_torch.distributed import (DEFAULT_RULES, Mesh, force_devices, forced_devices,
                                     logical_axis_rules, named_sharding, resolve_spec,
                                     visible_slots)
from repro_torch.distributed import sharding
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh_for_devices

torch.set_num_threads(1)


def _cpu_mesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("cpu")] * n
    return Mesh(grid.reshape(tuple(shape.values())), tuple(shape))


# ---------------------------------------------------------------------------
# The rule engine
# ---------------------------------------------------------------------------

_SPEC_CASES = [
    # (mesh shape, [(shape, logical names), ...])
    ({"data": 16, "model": 16}, [((4096, 4096), ("embed", "mlp")),
                                 ((65024, 4096), ("vocab", "embed")),
                                 ((8, 4096, 32, 128), ("layers", "embed", "q_heads", None)),
                                 ((4096, 2, 128), ("embed", "kv_heads", None)),
                                 ((256, 2048), ("batch", "seq")),
                                 ((3, 5), ("embed", "mlp"))]),
    ({"pod": 2, "data": 16, "model": 16}, [((512, 2048), ("batch", "seq")),
                                           ((48, 2048), ("batch", "seq")),
                                           ((8, 32768, 2, 128), ("batch", "kv_seq", "kv_heads",
                                                                 None))]),
    ({"data": 4, "model": 2}, [((8, 6), ("embed", "embed")),  # one mesh axis a tensor
                               ((8, 6), ("mlp", "q_heads")),
                               ((6, 7), ("kv_seq", "experts")),
                               ((16,), ("batch",)),
                               ((5,), ("batch",)),
                               ((4, 4), (None, "unknown"))]),
    ({"chains": 2, "data": 2}, [((32, 100), ("ensemble_chains", "subsample")),
                                ((32, 101), ("ensemble_chains", "subsample")),
                                ((33, 100), ("ensemble_chains", "subsample")),
                                ((32, 100, 50), ("ensemble_chains", "subsample", None)),
                                ((32, 50), ("ensemble_chains", None))]),
    ({"chains": 4}, [((32, 100), ("ensemble_chains", "subsample")),
                     ((6, 100), ("ensemble_chains", "subsample"))]),
    ({"chains": 1, "data": 4}, [((32, 100), ("ensemble_chains", "subsample")),
                                ((32, 102), ("ensemble_chains", "subsample"))]),
]


@pytest.mark.parametrize("mesh_shape,cases", _SPEC_CASES,
                         ids=["x".join(map(str, m.values())) for m, _ in _SPEC_CASES])
def test_resolve_spec_matches_reference(mesh_shape, cases):
    stand_in = types.SimpleNamespace(shape=dict(mesh_shape))
    mesh = _cpu_mesh(mesh_shape)
    for shape, logical in cases:
        want = j_sharding.resolve_spec(shape, logical, stand_in, j_sharding.DEFAULT_RULES)
        got = resolve_spec(shape, logical, mesh, DEFAULT_RULES)
        assert tuple(got) == tuple(want), (shape, logical)
        # named_sharding merges extra rules over the defaults, as the reference's does
        extra = {"mlp": (("data",),)}
        want = j_sharding.resolve_spec(shape, logical, stand_in,
                                       dict(j_sharding.DEFAULT_RULES, **extra))
        assert tuple(named_sharding(mesh, shape, logical, extra).spec) == tuple(want)
    assert DEFAULT_RULES == j_sharding.DEFAULT_RULES


def test_tree_shardings_and_count_bytes_match_reference():
    """chatglm3-6b's parameters on the production (16, 16) mesh shape."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import transformer as j_tf
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tf

    ref_specs = j_tf._flatten(j_tf.param_specs(J_ARCHS["chatglm3-6b"]))
    specs = tf._flatten(tf.param_specs(ARCHS["chatglm3-6b"]))
    assert sorted(specs) == sorted(ref_specs)
    stand_in = types.SimpleNamespace(shape={"data": 16, "model": 16})
    got = sharding.tree_shardings(_cpu_mesh({"data": 16, "model": 16}), specs)
    for k, v in ref_specs.items():
        want = j_sharding.resolve_spec(v.shape, v.logical, stand_in, j_sharding.DEFAULT_RULES)
        assert tuple(got[k].spec) == tuple(want), k
    assert sharding.count_bytes(specs) == j_sharding.count_bytes(ref_specs)


def test_shard_and_assemble_round_trip():
    mesh = _cpu_mesh({"chains": 2, "data": 2})
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    sh = named_sharding(mesh, x.shape, ("ensemble_chains", "subsample"))
    blocks = sh.owners(x.shape)
    assert tuple(sh.spec) == ("chains", "data")
    assert [b.slot for b in blocks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    pieces = sharding.shard_tensor(x, blocks)
    assert torch.equal(pieces[2], x[4:, :3]) and pieces[2].is_contiguous()
    assert torch.equal(sharding.assemble(pieces, blocks, x.shape, "cpu"), x)
    # m = 5: the data axis falls back to replicated, and slot (i, 0) owns rows i whole
    y = torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5)
    sh = named_sharding(mesh, y.shape, ("ensemble_chains", "subsample"))
    blocks = sh.owners(y.shape)
    assert tuple(sh.spec) == ("chains",) and [b.slot for b in blocks] == [(0, 0), (1, 0)]
    assert sh.slot_index((1, 1), y.shape) == blocks[1].index == (slice(4, 8), slice(0, 5))
    pieces = sharding.shard_tensor(y, blocks)
    assert torch.equal(pieces[1], y[4:])
    assert torch.equal(sharding.assemble(pieces, blocks, y.shape, "cpu"), y)


def test_lc_and_the_slot_policy():
    x = torch.ones(4, 4)
    assert sharding.lc(x, ("batch", None)) is x  # no active mesh
    with logical_axis_rules(_cpu_mesh({"data": 1})):
        assert sharding.lc(x, ("batch", None)) is x  # one slot
    with logical_axis_rules(_cpu_mesh({"data": 2, "model": 2})):
        # activations are whole on the home device under any mesh
        assert sharding.lc(x, ("batch", None)) is x
        assert sharding.active_mesh()[0].shape == {"data": 2, "model": 2}
    assert sharding.active_mesh() is None
    assert visible_slots("cpu") == [torch.device("cpu")] and forced_devices() is None
    with force_devices(4):
        with force_devices(3):
            assert len(visible_slots("cpu")) == 3
        assert visible_slots("cpu") == [torch.device("cpu")] * 4
        mesh = make_mesh_for_devices(device="cpu")
        assert mesh.shape == {"data": 4, "model": 1}
        assert make_mesh_for_devices(4, 2, device="cpu").shape == {"data": 2, "model": 2}
        with pytest.raises(ValueError):
            make_mesh_for_devices(4, 3, device="cpu")
    assert forced_devices() is None
    with pytest.raises(ValueError):
        with force_devices(0):
            pass
    t = torch.arange(10.0)
    assert sharding.place(t, "cpu") is t  # already there: no copy


# ---------------------------------------------------------------------------
# The ensemble's mesh: the reference's factorisation and messages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gauss():
    """A conjugate Gaussian closure target in both packages (numpy data)."""
    n = 400
    x = (0.7 + np.random.default_rng(1).standard_normal(n)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jt = J.from_iid_loglik(lambda th: -0.5 * jnp.sum(th ** 2),
                           lambda th, idx: -0.5 * (jx[idx] - th) ** 2, None, n)
    tt = from_iid_loglik(lambda th: -0.5 * th ** 2,
                         lambda th, idx: -0.5 * (tx[idx.long()] - th) ** 2, None, n)
    return jt, tt, x


@contextlib.contextmanager
def _reference_devices(monkeypatch, n):
    """The reference's ``_mesh_2d`` / ``_chain_mesh`` over n stand-in
    devices: ``jax.devices()`` returns n numbers and ``Mesh`` its array's
    shape."""
    with monkeypatch.context() as m:
        m.setattr(j_ensemble.jax, "devices", lambda *a: list(range(n)))
        m.setattr(jax.sharding, "Mesh", lambda devs, names: (np.asarray(devs).shape, names))
        yield


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 8, 12, 32])
def test_balanced_mesh_matches_reference(k, gauss, monkeypatch):
    jt, tt, _ = gauss
    cfg = SubsampledMHConfig(batch_size=20)
    for n in range(1, 17):
        for shard in (("chains", "data"), {"data": 2}, {"chains": 2}, {"chains": 2, "data": 4}):
            with _reference_devices(monkeypatch, n):
                want = _outcome(lambda: J.ChainEnsemble(jt, J.RandomWalk(0.1), k, config=cfg,
                                                        shard=shard)._mesh_2d)
            if want[0] == "ok" and want[1] is not None:
                want = ("ok", want[1][0])
            with force_devices(n):
                def port():
                    ens = ChainEnsemble(tt, RandomWalk(0.1), k, config=cfg, shard=shard,
                                        device="cpu")
                    return None if ens._mesh is None else ens._mesh.devices.shape
                got = _outcome(port)
            assert got == want, (n, k, shard)


def test_chain_mesh_matches_reference(gauss, monkeypatch):
    jt, tt, _ = gauss
    for n in (1, 2, 3, 4, 8):
        for k in (1, 4, 6, 8):
            for shard in ("auto", True, False):
                with _reference_devices(monkeypatch, n):
                    want = _outcome(lambda: J.ChainEnsemble(jt, J.RandomWalk(0.1), k,
                                                            shard=shard)._chain_mesh())
                if want[0] == "ok" and want[1] is not None:
                    want = ("ok", want[1][0])
                with force_devices(n):
                    def port():
                        mesh = ChainEnsemble(tt, RandomWalk(0.1), k, shard=shard,
                                             device="cpu")._mesh
                        return None if mesh is None else mesh.devices.shape
                    got = _outcome(port)
                assert got == want, (n, k, shard)


def test_shard_validation_messages_match_reference(gauss):
    """tests/test_fleet.py:483-495, and the construction rules beside them."""
    jt, tt, _ = gauss
    cfg = SubsampledMHConfig(batch_size=20, epsilon=0.05)
    cases = [dict(config=cfg, shard=("rows", "cols")),
             dict(config=cfg, shard={"chains": 2, "batch": 2}),
             dict(kernel="exact", shard=("chains", "data")),
             dict(config=cfg, shard="yes"),
             dict(config=cfg, shard=("chains", "data"), chain_axis="c"),
             dict(config=cfg, shard={"c": 2}, data_axis="d"),
             dict(config=cfg, stepping="masked", shard=True)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            J.ChainEnsemble(jt, J.RandomWalk(0.1), 4, **kw)
        with pytest.raises(ValueError) as got:
            ChainEnsemble(tt, RandomWalk(0.1), 4, device="cpu", **kw)
        assert str(got.value) == str(want.value), kw
    # the fused route's rule needs a target with an ensemble round
    x = np.random.default_rng(2).standard_normal((40, 2)).astype(np.float32)
    y = np.ones(40, np.float32)
    jl = J.build_target("logit", (jnp.asarray(x), jnp.asarray(y)), 40,
                        prior_logpdf=lambda w: -jnp.sum(w ** 2))
    tl = build_target("logit", (torch.tensor(x), torch.tensor(y)), 40,
                      prior_logpdf=lambda w: -(w ** 2).sum(-1))
    with pytest.raises(ValueError) as want:
        J.ChainEnsemble(jl, J.RandomWalk(0.1), 4, config=cfg, fused_kernels="always", shard=True)
    with pytest.raises(ValueError) as got:
        ChainEnsemble(tl, RandomWalk(0.1), 4, config=cfg, fused_kernels="always", shard=True,
                      device="cpu")
    assert str(got.value) == str(want.value)
    for msg, kw in (("must name the mesh axes", dict(shard=("rows", "cols"))),
                    ("subset", dict(shard={"chains": 2, "batch": 2})),
                    ("subsampled kernel", dict(kernel="exact", shard=("chains", "data"))),
                    ("'auto', True, False", dict(shard="yes"))):
        with pytest.raises(ValueError, match=msg):
            ChainEnsemble(tt, RandomWalk(0.1), 4, device="cpu", **kw)


def test_composite_and_unmovable_targets(gauss):
    from repro_torch.core import SubsampledMHOp, cycle

    _, tt, _ = gauss
    op = SubsampledMHOp(tt, RandomWalk(0.1), config=SubsampledMHConfig(batch_size=20))
    with pytest.raises(ValueError, match="2-d shard=\\(chains, data\\) mesh supports"):
        ChainEnsemble(num_chains=4, transition=cycle([op]), shard=("chains", "data"),
                      device="cpu")
    with pytest.raises(ValueError, match="use shard='auto' or False"):
        ChainEnsemble(num_chains=4, transition=cycle([op]), shard=True, device="cpu")
    with force_devices(4):
        assert ChainEnsemble(num_chains=4, transition=cycle([op]), device="cpu")._mesh is None
        # masked stepping shards on the 2-d mesh only
        assert ChainEnsemble(tt, RandomWalk(0.1), 4, stepping="masked", device="cpu")._mesh is None
        # a closure target is split in place when every slot is its home device
        assert ChainEnsemble(tt, RandomWalk(0.1), 4, shard=True, device="cpu")._mesh is not None
    # ... and cannot leave it: on other devices "auto" runs it unsharded, a request raises
    other = Mesh([torch.device("cpu"), torch.device("meta")], ("chains",))
    for shard, raises in (("auto", False), (True, True)):
        ens = ChainEnsemble(tt, RandomWalk(0.1), 4, shard=shard, device="cpu")
        ens.__dict__.pop("_mesh", None)
        object.__setattr__(ens, "_chain_mesh", lambda: other)
        if raises:
            with pytest.raises(ValueError, match="cannot leave its home device"):
                ens._mesh
        else:
            assert ens._mesh is None


# ---------------------------------------------------------------------------
# Sharded runs == the unsharded run, bit for bit
# ---------------------------------------------------------------------------


def _logit_target(n=240, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, d)).astype(np.float32))
    y = torch.tensor(np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32))
    return build_target("logit", (x, y), n, prior_logpdf=lambda w: -0.5 * (w ** 2).sum(-1)), d


def _conjugate_target(conjugate_posterior):
    x = torch.tensor(np.asarray(conjugate_posterior["data"], np.float32))
    n = conjugate_posterior["n"]
    return build_target("gaussian_mean", x, n,
                        prior_logpdf=lambda th: -0.5 * (th ** 2).sum(-1)), x.shape[1]


def _same(a, b) -> list[str]:
    """The fields in which two (state, samples, infos) runs differ."""
    bad = [] if torch.equal(a[1], b[1]) else ["samples"]
    bad += [f for f, u, v in zip(type(a[2])._fields, a[2], b[2]) if not torch.equal(u, v)]
    if a[0].controller is not None:
        bad += [f"controller.{f}" for f, u, v in zip(type(a[0].controller)._fields,
                                                     a[0].controller, b[0].controller)
                if not torch.equal(u, v)]
    return bad


_RUNS = [
    # (name, target, ensemble keywords, batch size, chains, steps)
    ("logit-lockstep-stream", "logit", dict(), 64, 8, 25),
    ("logit-masked-stream", "logit", dict(stepping="masked"), 64, 8, 25),
    ("logit-lockstep-fy", "logit", dict(sampler="fy"), 60, 8, 25),
    ("logit-masked-fy-schedule", "logit",
     dict(stepping="masked", sampler="fy", schedule=ScheduleConfig(epsilon_max=0.2)), 64, 8, 25),
    ("logit-lockstep-schedule", "logit", dict(schedule=ScheduleConfig(epsilon_max=0.2)), 64, 8,
     20),
    ("logit-m-not-divided", "logit", dict(), 51, 8, 20),
    ("logit-exact", "logit", dict(kernel="exact"), 64, 8, 10),
    ("conjugate-lockstep", "conjugate", dict(), 128, 4, 25),
    ("conjugate-masked", "conjugate", dict(stepping="masked"), 128, 4, 25),
    ("closure-lockstep", "closure", dict(), 50, 8, 25),
    ("closure-masked", "closure", dict(stepping="masked"), 50, 8, 25),
]


@pytest.mark.parametrize("name,kind,kw,m,k,steps", _RUNS, ids=[r[0] for r in _RUNS])
def test_sharded_run_is_the_unsharded_run(name, kind, kw, m, k, steps, gauss,
                                          conjugate_posterior):
    kw = dict(kw)
    sampler = kw.pop("sampler", "stream")
    if kind == "logit":
        target, d = _logit_target()
    elif kind == "conjugate":
        target, d = _conjugate_target(conjugate_posterior)
    else:
        target, d = gauss[1], None
    kernel = kw.pop("kernel", "subsampled")
    cfg = None if kernel == "exact" else SubsampledMHConfig(batch_size=m, epsilon=0.05,
                                                            sampler=sampler)
    theta0 = torch.zeros(()) if d is None else torch.zeros(d)

    def run(shard):
        ens = ChainEnsemble(target, RandomWalk(0.1), k, config=cfg, kernel=kernel, shard=shard,
                            device="cpu", **kw)
        return ens, ens.run(3, ens.init(theta0), steps)

    _, base = run(False)
    shards = [("chains", "data"), {"chains": 2, "data": 2}, {"data": 4}]
    if kw.get("stepping") != "masked":
        shards.append(True)
    with force_devices(4):
        for shard in shards:
            if kernel == "exact" and shard is not True:
                continue
            ens, got = run(shard)
            assert ens._mesh is not None and ens._mesh.size == 4
            assert _same(got, base) == [], (name, shard)


def test_rounds_are_split_over_the_slots():
    """What each slot scores: rows i and columns j of the (K, m) block,
    with the data axis left whole when d does not divide m."""
    import dataclasses

    from repro_torch.core import target_builder as tb

    fam = tb.get_family("logit")
    seen = []
    spy = dataclasses.replace(fam, ensemble_delta=lambda *a, **kw: (
        seen.append((tuple(a[1].shape), tuple(a[-1].shape))) or fam.ensemble_delta(*a, **kw)))
    tb.register_family(spy)
    try:
        target, d = _logit_target()
        with force_devices(4):
            for shard, m, want in ((True, 64, ((2, 3), (2, 64))),
                                   (("chains", "data"), 64, ((4, 3), (4, 32))),
                                   ({"data": 4}, 64, ((8, 3), (8, 16))),
                                   ({"chains": 2, "data": 2}, 51, ((4, 3), (4, 51)))):
                seen.clear()
                cfg = SubsampledMHConfig(batch_size=m, epsilon=0.05, sampler="stream")
                ens = ChainEnsemble(target, RandomWalk(0.1), 8, config=cfg, shard=shard,
                                    device="cpu")
                ens.run(3, ens.init(torch.zeros(d)), 2)
                assert set(seen) == {want}, shard
                assert len(seen) % (4 if m == 64 else 2) == 0
    finally:
        tb.register_family(fam)


def _family_target(family, k, rng):
    if family == "gaussian_ar1":
        n = 300
        pools = tuple(torch.tensor(rng.standard_normal((k, n)).astype(np.float32))
                      for _ in range(2))  # per-chain (K, N) pools
        theta = (torch.tensor(rng.uniform(0.5, 0.9, k).astype(np.float32)),
                 torch.tensor(rng.uniform(0.5, 1.5, k).astype(np.float32)))
        return build_target(family, pools, n, prior_logpdf=lambda t: -(t[0] ** 2)), theta, n
    if family == "ce":
        n, d, v = 300, 64, 1000
        data = (torch.tensor(rng.standard_normal((n, d)).astype(np.float32)),
                torch.tensor(rng.integers(0, v, n)))
        theta = torch.tensor(0.1 * rng.standard_normal((k, v, d)).astype(np.float32))
        return build_target(family, data, n, prior_logpdf=lambda t: -(t ** 2).sum((-1, -2))), \
            theta, n
    target, d = _logit_target(n=1000, d=50)  # BayesLR's width
    return target, torch.tensor(0.1 * rng.standard_normal((k, d)).astype(np.float32)), 1000


@pytest.mark.parametrize("family", ["logit", "gaussian_ar1", "ce"])
def test_family_rounds_split_bit_for_bit(family):
    """Each kernel family's (K, m) round under 2 x 2, 1 x 4 and 4 x 1 meshes
    equals the whole round bit for bit (gaussian_ar1 on per-chain pools,
    which each slot reads by its rows), with m that 4 divides (C's 100 and
    L's 400) and one it does not."""
    from repro_torch._device import tree_map

    rng = np.random.default_rng(5)
    k = 8
    target, theta, n = _family_target(family, k, rng)
    theta_p = tree_map(lambda t: t + 0.01, theta)
    for m in (100, 102, 400):
        idx = torch.tensor(rng.integers(0, n, (k, m)).astype(np.int32))
        whole = target.local_round(theta, theta_p, ensemble=True)(idx)
        for shape in ((2, 2), (1, 4), (4, 1)):
            with logical_axis_rules(_cpu_mesh({"chains": shape[0], "data": shape[1]})):
                got = target.local_round(theta, theta_p, ensemble=True)(idx)
            assert torch.equal(got, whole), (family, m, shape)


def test_sharded_run_matches_reference_in_distribution(conjugate_posterior):
    """A 2 x 2 sharded run of the conjugate harness (tests/conftest.py:79)
    against the reference's unsharded run at its settings: both chains'
    means within 0.5 posterior sd of the exact posterior mean and of each
    other, and variances within a factor 2 of the exact one."""
    c = conjugate_posterior
    n, d, k = c["n"], c["d"], c["chains"]
    ref = np.concatenate([w.reshape(-1, d) for w in c["run"](1)])
    target, _ = _conjugate_target(c)
    cfg = SubsampledMHConfig(batch_size=128, epsilon=0.005, sampler="stream")
    with force_devices(4):
        ens = ChainEnsemble(target, RandomWalk(1.7 * float(np.sqrt(1.0 / (n + 1.0)))), k,
                            config=cfg, shard=("chains", "data"), device="cpu")
        assert ens._mesh.shape == {"chains": 2, "data": 2}
        gen = torch.Generator().manual_seed(4)
        state, _, _ = ens.run(gen, ens.init(torch.zeros(d)), 250)
        _, samples, _ = ens.run(gen, state, 350)
    got = samples.reshape(-1, d).double().numpy()
    sd = np.sqrt(c["post_var"])
    assert np.abs(got.mean(0) - c["post_mean"]).max() < 0.5 * sd
    assert np.abs(ref.mean(0) - c["post_mean"]).max() < 0.5 * sd
    assert np.abs(got.mean(0) - ref.mean(0)).max() < 0.5 * sd
    for v in (got.var(0), ref.var(0)):
        assert np.all((v > 0.5 * c["post_var"]) & (v < 2.0 * c["post_var"]))


# ---------------------------------------------------------------------------
# The fleet and the front end
# ---------------------------------------------------------------------------


def _fleet(mesh):
    from repro_torch.fleet import Fleet, FleetConfig
    from repro_torch.serving import FreshnessPolicy, ServingConfig

    cfg = FleetConfig(
        replicas=2, shards=1, mesh=mesh,
        serving=ServingConfig(num_chains=4, refresh_steps=8, window=16, micro_batch=8,
                              freshness=FreshnessPolicy(max_staleness_s=1e9, min_draws=8),
                              seed=0, device="cpu"))
    fleet = Fleet(cfg)
    fleet.add_workload("bayeslr", smoke=True, n_train=400, d=3, batch_size=50)
    return fleet


def test_sharded_fleet_checkpoint_roundtrip_at_4_devices(tmp_path):
    """The reference's test (tests/test_fleet.py:602-647) in process: a fleet
    whose writers run the 2-d mesh checkpoints and restores warm, the
    restored run continues bit for bit and the replicas mirror it; and the
    sharded writer equals an unsharded fleet's."""
    with force_devices(4):
        f1 = _fleet(("chains", "data"))
        f1.warm()
        f1.save(str(tmp_path))
        f2 = _fleet(("chains", "data"))
        step = f2.restore(str(tmp_path))
        f1.pump()
        f2.pump()
        f3 = _fleet(False)
        f3.warm()
        f3.pump()
    try:
        s1, s2, s3 = (f.shards("bayeslr")[0] for f in (f1, f2, f3))
        assert s1.writer.ensemble._mesh.shape == {"chains": 2, "data": 2}
        assert s3.writer.ensemble._mesh is None
        assert step is not None
        w1, w2 = s1.writer.snapshot().draws, s2.writer.snapshot().draws
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(s1.replicas[1].snapshot().draws,
                                      s2.replicas[1].snapshot().draws)
        np.testing.assert_array_equal(w2, s2.replicas[1].snapshot().draws)
        np.testing.assert_array_equal(w1, s3.writer.snapshot().draws)
    finally:
        for f in (f1, f2, f3):
            f.close()


def test_front_end_fleet_mesh_2d_devices_4():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--fleet", "--mesh", "2d", "--devices", "4", "--smoke",
                         "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0, text[-2000:]
    assert "mesh=2d devices=4" in text
    last = text.strip().splitlines()[-1]
    assert last.startswith("SERVE_OK") and "parity=ok(bitexact)" in last
    assert " devices=4" in last
    assert forced_devices() is None  # the forcing ends with the fleet
