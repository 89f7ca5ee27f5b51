"""The port's last pieces against the JAX package: the theory curve of Fig. 5
(``sequential_test.expected_batches_theoretical``), ``stats.predictive_risk``,
``stats.SLOReportDict``, ``experiments.bayeslr.loglik``; ``sgld_step``
drawing each leaf's noise just before its update; a ``ce`` ensemble on a mesh
of CPU slots; and ``shard="auto"``'s rule. The fleet's ``lanes_per_shard``
and ``sync_interval_s`` are held in ``tests/test_torch_fleet.py``.
"""
import json
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import expected_batches_theoretical as j_expected_batches
from repro.core import predictive_risk as j_predictive_risk
from repro.core.stats import SLOReportDict as JSLOReportDict
from repro.experiments import bayeslr as j_bayeslr
from repro_torch.core import (ChainEnsemble, RandomWalk, SubsampledMHConfig, build_target,
                              expected_batches_theoretical, predictive_risk)
from repro_torch.core.stats import SLOReportDict, build_slo_report
from repro_torch.distributed import Mesh, force_devices
from repro_torch.experiments import bayeslr
from repro_torch.kernels import ref
from repro_torch.optim import optimizers, sgld_step
from repro_torch.serving.queue import Request

torch.set_num_threads(1)


@pytest.mark.parametrize("n,mu,sd,mu0,m,eps", [
    (1000, 0.02, 1.0, 0.0, 50, 0.05), (12214, 0.001, 0.3, 0.0005, 100, 0.05),
    (5000, -0.01, 2.0, 0.0, 500, 0.01), (300, 0.0, 1.0, 0.0, 64, 0.2), (64, 0.5, 0.0, 0.1, 8, 0.05)])
def test_expected_batches_theoretical_matches_reference(n, mu, sd, mu0, m, eps):
    """The same l values (numpy, a seed): the port's copy and the
    reference's agree to 1e-12 relative (both host float64)."""
    l = mu + sd * np.random.default_rng(n).standard_normal(n)
    want = j_expected_batches(l, mu0, m, eps)
    got = expected_batches_theoretical(l, mu0, m, eps)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert 0 < got <= n


@pytest.mark.parametrize("shape", [(50,), (4, 30), (3, 2, 5)])
def test_predictive_risk_matches_reference(shape):
    """One chain or several: equal to 1e-12 relative; a torch tensor gives
    what its numpy array gives."""
    est = np.random.default_rng(len(shape)).standard_normal(shape)
    want = j_predictive_risk(est, 0.3)
    assert predictive_risk(est, 0.3) == pytest.approx(want, rel=1e-12)
    assert predictive_risk(torch.tensor(est), 0.3) == pytest.approx(want, rel=1e-12)


def _request(latency_s):
    now = time.perf_counter()
    req = Request(workload="w", query_class="c", xs=np.zeros((1, 1), np.float32),
                  deadline_s=1.0, submitted_at=now)
    req.values, req.latency_s, req.deadline_met = np.zeros(1, np.float32), latency_s, True
    req.batch_size = 1
    return req


def test_slo_report_dict_aliases_warns_and_iterates_as_reference():
    """``SLOReport.to_dict`` returns an ``SLOReportDict``: ``total_requests``
    answers ``count`` with a DeprecationWarning (``[]`` and ``get``), is
    not a key for ``in``, iteration or JSON, and an unknown key stays a
    plain KeyError / get default; the reference's dict behaves alike."""
    report = build_slo_report([_request(0.01)]).to_dict()
    theirs = JSLOReportDict(dict(report))
    assert isinstance(report, SLOReportDict) and isinstance(report, dict)
    for r in (report, theirs):
        with pytest.warns(DeprecationWarning, match="total_requests"):
            assert r["total_requests"] == r["count"] == 1
        with pytest.warns(DeprecationWarning):
            assert r.get("total_requests") == 1
        assert "total_requests" not in r and "total_requests" not in list(r)
        assert "total_requests" not in json.dumps(r)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(KeyError):
                r["no_such_key"]
            assert r.get("no_such_key", "fallback") == "fallback"
    assert list(report) == list(theirs) and report == theirs


def test_bayeslr_loglik_is_the_shared_logistic_factor():
    """``bayeslr.loglik`` is the port's ``kernels.ref.logit_loglik``, as the
    reference's is its own; on the same inputs they agree to 1e-6."""
    assert bayeslr.loglik is ref.logit_loglik
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    y = np.where(rng.uniform(size=20) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(j_bayeslr.loglik(w, x, y))
    got = bayeslr.loglik(torch.tensor(w), torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _sgld_all_first(gen, grads, params, lr, temperature=1.0):
    """The step as it drew every leaf's noise whole before any update."""
    scale = (2.0 * lr * temperature) ** 0.5
    noise = {}
    for path in optimizers._sorted_paths(params):
        p = optimizers._at(params, path)
        noise[path] = torch.randn(p.shape, generator=gen, dtype=torch.float32)
    return optimizers._with_paths(lambda path, p, g: (
        p.float() + lr * g.float() + scale * noise[path]).to(p.dtype), params, grads)


def test_sgld_draws_each_leaf_just_before_its_update(monkeypatch):
    """Bit for bit the all-first draw (the same generator stream: the
    updates draw nothing), leaves in bf16 and float32 in a nested tree whose
    insertion order is not sorted; and each leaf's draw follows the
    previous leaf's update, so at most one noise leaf lives at a time."""
    rng = np.random.default_rng(9)
    shapes = {"z": (7, 3), "a": {"y": (5,), "b": (2, 4, 3)}, "m": (11,)}

    def tree(scale):
        out = {}
        for k, v in shapes.items():
            out[k] = ({kk: torch.tensor(scale * rng.standard_normal(vv), dtype=torch.float32)
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else torch.tensor(scale * rng.standard_normal(v), dtype=torch.bfloat16))
        return out

    params, grads = tree(1.0), tree(0.1)
    want = _sgld_all_first(torch.Generator().manual_seed(4), grads, params, 1e-2)
    events = []
    real_randn, real_map_rows = torch.randn, optimizers.map_rows
    monkeypatch.setattr(optimizers.torch, "randn", lambda *a, **kw: (
        events.append(("draw", tuple(a[0]))), real_randn(*a, **kw))[1])
    monkeypatch.setattr(optimizers, "map_rows", lambda fn, ts: (
        events.append(("update", tuple(ts[0].shape))), real_map_rows(fn, ts))[1])
    got = sgld_step(torch.Generator().manual_seed(4), grads, params, 1e-2)
    monkeypatch.undo()
    flat = lambda t: [optimizers._at(t, p) for p in optimizers._sorted_paths(t)]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert list(got) == list(params) and list(got["a"]) == list(params["a"])
    order = [tuple(optimizers._at(params, p).shape) for p in optimizers._sorted_paths(params)]
    assert events == [e for s in order for e in (("draw", s), ("update", s))]


def _ce_target(k, rng):
    n, d, v = 300, 64, 1000
    data = (torch.tensor(rng.standard_normal((n, d)).astype(np.float32)),
            torch.tensor(rng.integers(0, v, n).astype(np.int32)))
    target = build_target("ce", data, n, prior_logpdf=lambda t: -(t ** 2).sum((-1, -2)))
    return target, torch.tensor(0.05 * rng.standard_normal((k, v, d)).astype(np.float32))


@pytest.mark.parametrize("shard,mesh", [(True, {"chains": 4}),
                                        (("chains", "data"), {"chains": 2, "data": 2})])
def test_ce_ensemble_on_cpu_slots_is_unsharded(shard, mesh):
    """A K=8 ``ce`` ensemble (per-chain (V, D) tables) on four CPU slots,
    4-chain and 2 x 2, against ``shard=False`` from one seed: samples and
    every info field bit for bit."""
    target, theta = _ce_target(8, np.random.default_rng(2))
    cfg = SubsampledMHConfig(batch_size=40, epsilon=0.05, sampler="fy")
    kw = dict(config=cfg, device="cpu", collect=lambda t: t[:, :2, :3].clone())
    want_ens = ChainEnsemble(target, RandomWalk(0.002), 8, shard=False, **kw)
    _, want, want_infos = want_ens.run(3, want_ens.init(theta, batched=True), 4)
    with force_devices(4):
        ens = ChainEnsemble(target, RandomWalk(0.002), 8, shard=shard, **kw)
        assert ens._mesh.shape == mesh
        _, got, infos = ens.run(3, ens.init(theta, batched=True), 4)
    assert torch.equal(got, want)
    for a, b in zip(infos, want_infos):
        assert torch.equal(a, b)
    assert 0 < int(infos.accepted.sum()) < infos.accepted.numel()


def _slots(*devices):
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid, ("chains",))


def test_shard_auto_rule_chooses_as_its_docstring_says():
    """``shard="auto"`` keeps a chain mesh of slots that are no card (CPU
    slots: the reference's rule) and drops every mesh with a card among its
    slots (four cards, four slots of one card, a mix), for every family;
    an explicit ``shard=True`` is not decided by the rule."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((40, 3)).astype(np.float32))
    logit = build_target("logit", (x, torch.ones(40)), 40,
                         prior_logpdf=lambda w: -(w ** 2).sum(-1))
    ce, _ = _ce_target(4, rng)
    meshes = {"cpu": (_slots("cpu", "cpu", "cpu", "cpu"), True),
              "cards": (_slots("cuda:0", "cuda:1", "cuda:2", "cuda:3"), False),
              "one_card": (_slots("cuda:0", "cuda:0", "cuda:0", "cuda:0"), False),
              "mixed": (_slots("cpu", "cuda:0", "cpu", "cuda:1"), False)}
    for target in (logit, ce):
        ens = ChainEnsemble(target, RandomWalk(0.1), 4, device="cpu")
        for where, (mesh, keeps) in meshes.items():
            assert ens._auto_builds(mesh) is keeps, (target.family, where)
    with force_devices(4):  # CPU slots: "auto" builds the mesh, as the reference's does
        for target in (logit, ce):
            assert ChainEnsemble(target, RandomWalk(0.1), 4,
                                 device="cpu")._mesh.shape == {"chains": 4}
            assert ChainEnsemble(target, RandomWalk(0.1), 4, shard=True,
                                 device="cpu")._mesh.shape == {"chains": 4}


@pytest.mark.parametrize("check_every", [1, 16, 200])
def test_betainc_stops_early_with_the_cap_bits(check_every):
    """The Student-t tail's recurrence looked at every 1 (the CPU's
    default), 16 (the card's) or never (the 200-step cap) gives the same
    bits at df 1..1e5: a converged element is frozen."""
    from repro_torch.kernels.ref import BETAINC_MAX_ITERS, betainc_fp32

    rng = np.random.default_rng(7)
    df = torch.tensor(rng.choice([1, 2, 5, 30, 300, 3000, 1e5], 4000).astype(np.float32))
    t = torch.tensor(np.abs(3.0 * rng.standard_normal(4000)).astype(np.float32))
    x, b = df / (df + t * t), torch.full((4000,), 0.5)
    want = betainc_fp32(df / 2.0, b, x, check_every=BETAINC_MAX_ITERS)
    got = betainc_fp32(df / 2.0, b, x, check_every=check_every)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
