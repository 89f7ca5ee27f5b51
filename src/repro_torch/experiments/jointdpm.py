"""Joint Dirichlet-process mixture of logistic experts (paper Sec. 4.2), the
port of ``repro.experiments.jointdpm``.

    (x_i, y_i) | P ~ f(x, y | P),   P ~ DP(alpha P0)
    f(x, y | P) = sum_k pi_k N(x | mu_k, Sigma_k) Logit(y | x, w_k)

(mu_k, Sigma_k) are collapsed under a conjugate NIW prior; the DP is
collapsed to a CRP. Inference is the paper's program (Fig. 7):

    [infer (cycle ((mh alpha all 1)
                   (gibbs z one step_z)
                   (subsampled_mh w one {Nbatch} {eps} 'drift {sigma} 1)) 1)]

 - z: single-site Gibbs by Neal's Algorithm 8 (one auxiliary component)
   over O(1)-updatable NIW statistics, one kernel launch a sweep for all
   replicas (:mod:`repro_torch.kernels.gibbs_z`);
 - alpha: random-walk MH on log(alpha) against the CRP partition likelihood;
 - w_k: subsampled MH over a randomly chosen expert's weights, whose local
   sections are the N_k member points: a pool whose size is itself random,
   one per replica (the sequential test's per-chain ``num_sections``). The
   rows are scored by the logit pair delta on ``x_aug = [x, 1]``.

Every operation has a batched form over K replicas (a leading (K,) axis on
every state leaf), the form the ensemble runs in lock-step; the one-replica
functions run it at K = 1, so an ensemble of one replica draws what the
sequential run draws. Finding the members of the chosen expert is a stable
argsort of the (K, N) assignments, O(N) per w move as in the reference: the
sublinear count of evaluated sections does not make the w move sublinear in
time.

Data and the initial state are drawn on the device from a seeded
``torch.Generator``; to start from the JAX package's arrays use
:func:`repro_torch.convert.jdpm_data` and :func:`repro_torch.convert.jdpm_state`.
Entry points take ``device=None`` (the card; raises without one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import make_generator, resolve_device, tree_map
from ..core.composite import CycleOp, SweepOp, cycle, run_cycle_sequential
from ..core.ensemble import ChainEnsemble
from ..core.samplers import fy_draw, fy_from_buffer, fy_reset
from ..core.sequential_test import sequential_test
from ..core.subsampled_mh import draw_log_u
from ..inference.niw import ClusterStats, NIWPrior, predictive_all_clusters, predictive_rows
from ..kernels import ops
from ..kernels.gibbs_z import draw_sweep_randomness
from ..kernels.ref import lgamma_fp32

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class JDPMConfig:
    k_max: int = 20
    d: int = 2
    prior_var_w: float = 1.0
    alpha_a: float = 1.0  # Gamma(a, rate) prior on alpha
    alpha_rate: float = 1.0
    niw_k0: float = 0.1
    niw_v0: float = 4.0
    niw_s0_scale: float = 1.0

    def niw_prior(self, device=None) -> NIWPrior:
        dev = resolve_device(device)
        return NIWPrior(
            m0=torch.zeros((self.d,), dtype=F32, device=dev),
            k0=self.niw_k0,
            v0=self.niw_v0,
            s0=self.niw_s0_scale * torch.eye(self.d, dtype=F32, device=dev),
        )


class JDPMState(NamedTuple):
    z: torch.Tensor  # (N,) int32 assignments
    w: torch.Tensor  # (K_max, D+1) expert weights (last column = bias)
    alpha: torch.Tensor  # () CRP concentration
    stats: ClusterStats  # NIW sufficient statistics per cluster


class JDPMData(NamedTuple):
    x: torch.Tensor  # (N, D)
    y: torch.Tensor  # (N,) in {-1, +1}
    x_test: torch.Tensor
    y_test: torch.Tensor
    x_aug: torch.Tensor | None = None  # (N, D+1) = [x, 1], the w move's pool


def augment(x: torch.Tensor) -> torch.Tensor:
    """[x, 1]: the rows the experts' weights (bias last) score."""
    return torch.cat([x, torch.ones_like(x[:, :1])], -1).contiguous()


def _x_aug(data: JDPMData) -> torch.Tensor:
    return data.x_aug if data.x_aug is not None else augment(data.x)


def synth(seed=0, n: int = 10_000, n_test: int = 1_000, *, device=None) -> JDPMData:
    """Paper-Fig-6b-style synthetic: several anisotropic blobs, each with its
    own linear label boundary (so no single global logistic fits)."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    centers = torch.tensor([[-2.5, 0.0], [2.5, 0.0], [0.0, 2.5], [0.0, -2.5]], device=dev)
    w_per = torch.tensor([[2.0, 1.0], [-2.0, 1.0], [1.0, -2.0], [-1.0, -2.0]], device=dev)
    total = n + n_test
    comp = torch.randint(0, 4, (total,), generator=gen, device=dev)
    xs = centers[comp] + 0.7 * torch.randn((total, 2), generator=gen, device=dev)
    logits = ((xs - centers[comp]) * w_per[comp]).sum(-1)
    u = torch.rand((total,), generator=gen, device=dev)
    ys = torch.where(u < torch.sigmoid(2.0 * logits), 1.0, -1.0)
    x = xs[:n].contiguous()
    return JDPMData(x, ys[:n].contiguous(), xs[n:].contiguous(), ys[n:].contiguous(), augment(x))


def init_state(seed, data: JDPMData, cfg: JDPMConfig) -> JDPMState:
    """Three clusters at random, w from its prior, alpha = 1. ``seed`` is an
    int or a generator on the data's device. The statistics are summed in
    float64 (:meth:`ClusterStats.from_assignments`), so a seeded run repeats
    bit for bit on the card; the reference adds the points one by one in
    float32."""
    dev = data.x.device
    gen = make_generator(seed, dev)
    n = data.x.shape[0]
    z = torch.randint(0, 3, (n,), generator=gen, device=dev).to(torch.int32)
    w = math.sqrt(cfg.prior_var_w) * torch.randn((cfg.k_max, cfg.d + 1), generator=gen, device=dev)
    stats = ClusterStats.from_assignments(data.x, z, cfg.k_max)
    return JDPMState(z=z, w=w, alpha=torch.tensor(1.0, device=dev), stats=stats)


def _batch(tree):
    return tree_map(lambda l: l[None], tree)


def _unbatch(tree):
    return tree_map(lambda l: l[0], tree)


# ---------------------------------------------------------------------------
# Gibbs over assignments (Neal Algorithm 8, one auxiliary component)
# ---------------------------------------------------------------------------


def batched_gibbs_z_steps(gen: torch.Generator, state: JDPMState, data: JDPMData,
                          cfg: JDPMConfig, points: torch.Tensor) -> JDPMState:
    """Single-site Gibbs transitions of K replicas (every state leaf with a
    leading (K,) axis) at their points (K, P), in order: one launch of the
    sweep kernel on the card. The random numbers (the auxiliary experts'
    prior draws, one uniform a step) come from ``gen``."""
    k, p = points.shape
    nrm, u = draw_sweep_randomness(gen, k, p, cfg.d, data.x.device)
    z, w = state.z.clone(), state.w.clone()  # the kernel updates in place
    stats = ClusterStats(*(s.clone() for s in state.stats))
    ops.gibbs_z_sweep(data.x, data.y, z, w, torch.log(state.alpha), stats,
                      points.to(torch.int32).contiguous(), nrm, u, cfg.niw_prior(data.x.device),
                      math.sqrt(cfg.prior_var_w))
    return JDPMState(z=z, w=w, alpha=state.alpha, stats=stats)


def gibbs_z_steps(gen: torch.Generator, state: JDPMState, data: JDPMData, cfg: JDPMConfig,
                  points: torch.Tensor) -> JDPMState:
    """Single-site Gibbs transitions of one replica for the given points."""
    return _unbatch(batched_gibbs_z_steps(gen, _batch(state), data, cfg, points[None]))


# ---------------------------------------------------------------------------
# MH over alpha (CRP partition likelihood)
# ---------------------------------------------------------------------------


def _crp_log_partition(alpha, counts):
    k_active = (counts > 0.5).sum(-1)
    n = counts.sum(-1)
    return k_active * torch.log(alpha) + lgamma_fp32(alpha) - lgamma_fp32(alpha + n)


def alpha_log_posterior(alpha, log_alpha, counts, cfg: JDPMConfig):
    """log p(alpha | partition) on the log(alpha) scale (Gamma prior, CRP
    partition likelihood, Jacobian), the target of :func:`mh_alpha`."""
    prior = (cfg.alpha_a * math.log(cfg.alpha_rate) + (cfg.alpha_a - 1) * log_alpha
             - cfg.alpha_rate * alpha)
    return prior + _crp_log_partition(alpha, counts) + log_alpha


def batched_mh_alpha(gen: torch.Generator, state: JDPMState, cfg: JDPMConfig,
                     step: float = 0.3) -> JDPMState:
    """One random-walk MH move on log(alpha) for K replicas."""
    alpha = state.alpha
    log_a = torch.log(alpha)
    log_a_p = log_a + step * torch.randn(alpha.shape, generator=gen, device=alpha.device)
    a_p = torch.exp(log_a_p)
    counts = state.stats.n
    log_ratio = (alpha_log_posterior(a_p, log_a_p, counts, cfg)
                 - alpha_log_posterior(alpha, log_a, counts, cfg))
    accept = draw_log_u(gen, alpha.shape, alpha.device) < log_ratio
    return state._replace(alpha=torch.where(accept, a_p, alpha))


def mh_alpha(gen: torch.Generator, state: JDPMState, cfg: JDPMConfig,
             step: float = 0.3) -> JDPMState:
    return _unbatch(batched_mh_alpha(gen, _batch(state), cfg, step))


# ---------------------------------------------------------------------------
# Subsampled MH over a randomly chosen expert's weights
# ---------------------------------------------------------------------------


class WMoveInfo(NamedTuple):
    cluster: torch.Tensor
    accepted: torch.Tensor
    n_evaluated: torch.Tensor
    n_k: torch.Tensor
    rounds: torch.Tensor


class WProposal(NamedTuple):
    cluster: torch.Tensor  # (K,) int32, a non-empty expert
    n_k: torch.Tensor  # (K,) int32, its member count
    w_cur: torch.Tensor  # (K, D+1)
    w_prop: torch.Tensor  # (K, D+1)
    log_u: torch.Tensor  # (K,)


def propose_w(gen: torch.Generator, state: JDPMState, sigma_prop: float) -> WProposal:
    """The first draws of a w move for K replicas: a non-empty expert
    uniformly at random (one uniform), log u, then the random-walk proposal
    of its weights."""
    counts, w = state.stats.n, state.w
    k, dev = counts.shape[0], counts.device
    u_pick = torch.rand((k,), generator=gen, device=dev)
    log_u = draw_log_u(gen, (k,), dev)
    nonempty = counts > 0.5
    n_ne = nonempty.sum(-1)
    r = torch.minimum((u_pick * n_ne).long(), n_ne - 1)
    k_sel = (nonempty.cumsum(-1) <= r[:, None]).sum(-1)  # the (r+1)-th non-empty expert
    rows = torch.arange(k, device=dev)
    w_cur = w[rows, k_sel]
    w_prop = w_cur + sigma_prop * torch.randn(w_cur.shape, generator=gen, device=dev)
    n_k = counts[rows, k_sel].to(torch.int32)
    return WProposal(k_sel.to(torch.int32), n_k, w_cur, w_prop, log_u)


def _w_move(gen, state: JDPMState, data: JDPMData, cfg: JDPMConfig, *, batch_size: int,
            epsilon: float, sigma_prop: float, exact: bool, one_replica: bool):
    """One (subsampled) MH transition on a random non-empty expert's w for K
    replicas. The local sections are the expert's N_k members: positions
    [0, N_k) of a Fisher–Yates pool over ``arange(N)``, read through the
    member list, so each replica tests over a pool of its own size."""
    n = data.x.shape[0]
    x_aug = _x_aug(data)
    prop = propose_w(gen, state, sigma_prop)
    k = prop.n_k.shape[0]
    rows = torch.arange(k, device=x_aug.device)
    # members[:, :N_k] are each replica's points of its expert, in data order
    members = torch.argsort((state.z != prop.cluster[:, None]).to(torch.uint8), dim=-1,
                            stable=True).to(torch.int32)
    g = (-0.5 / cfg.prior_var_w) * ((prop.w_prop ** 2).sum(-1) - (prop.w_cur ** 2).sum(-1))
    mu0 = (prop.log_u - g) / torch.clamp_min(prop.n_k, 1)

    def eval_fn(pos):
        idx = members.gather(1, pos.long())
        if one_replica:
            return ops.logit_delta(x_aug, data.y, prop.w_cur[0], prop.w_prop[0], idx=idx[0])[None]
        return ops.gather_and_delta(x_aug, data.y, idx, prop.w_cur, prop.w_prop)

    pool = torch.arange(n, dtype=torch.int32, device=x_aug.device).repeat(k, 1)
    res = sequential_test(
        gen, mu0, fy_draw, eval_fn, fy_reset(fy_from_buffer(pool, prop.n_k)),
        num_sections=prop.n_k, batch_size=batch_size,
        epsilon=0.0 if exact else epsilon,  # epsilon 0: never stop early (exact)
        max_rounds=-(-n // batch_size),
    )
    w_new = state.w.clone()
    w_new[rows, prop.cluster.long()] = torch.where(res.decision[:, None], prop.w_prop, prop.w_cur)
    info = WMoveInfo(cluster=prop.cluster, accepted=res.decision, n_evaluated=res.n_evaluated,
                     n_k=prop.n_k, rounds=res.rounds)
    return state._replace(w=w_new), info


def batched_subsampled_mh_w(gen: torch.Generator, state: JDPMState, data: JDPMData,
                            cfg: JDPMConfig, batch_size: int = 100, epsilon: float = 0.1,
                            sigma_prop: float = 0.1,
                            exact: bool = False) -> tuple[JDPMState, WMoveInfo]:
    """:func:`subsampled_mh_w` for K replicas in lock-step: one (K, m) round
    of the logit pair delta and one round op a round, each replica against
    its own N_k."""
    return _w_move(gen, state, data, cfg, batch_size=batch_size, epsilon=epsilon,
                   sigma_prop=sigma_prop, exact=exact, one_replica=False)


def subsampled_mh_w(gen: torch.Generator, state: JDPMState, data: JDPMData, cfg: JDPMConfig,
                    batch_size: int = 100, epsilon: float = 0.1, sigma_prop: float = 0.1,
                    exact: bool = False) -> tuple[JDPMState, WMoveInfo]:
    """One (subsampled) MH transition on w_k for a random non-empty cluster.
    The local-section pool is the cluster's member list with logical size
    N_k, a dynamic pool (the paper's point that the number of austerity
    instances is an object of inference). ``exact=True`` runs the test with
    epsilon 0, so it evaluates all N_k members."""
    st, info = _w_move(gen, _batch(state), data, cfg, batch_size=batch_size, epsilon=epsilon,
                       sigma_prop=sigma_prop, exact=exact, one_replica=True)
    return _unbatch(st), _unbatch(info)


# ---------------------------------------------------------------------------
# The paper's inference program on the ensemble engine
# ---------------------------------------------------------------------------


def make_inference_cycle(data: JDPMData, cfg: JDPMConfig, *, batch_size: int = 100,
                         epsilon: float = 0.1, sigma_prop: float = 0.3, gibbs_frac: float = 0.5,
                         w_moves: int = 10) -> CycleOp:
    """The paper's Fig-7 program as a composite cycle:

        [infer (cycle ((mh alpha all 1) (gibbs z one step_z)
                       (subsampled_mh w one {Nbatch} {eps} 'drift {sigma} 1)) 1)]

    ``alpha`` and ``z`` are sweeps; the ``w`` component applies ``w_moves``
    subsampled-MH transitions (each on a random non-empty expert, its member
    pool the local sections) and records their :class:`WMoveInfo`, stacked
    on the last axis. Each component has its K-replica form as
    ``batched_fn``, so one cycle object serves the sequential run and the
    lock-step ensemble; the one-replica forms run them at K = 1 and draw the
    same numbers.
    """
    n = data.x.shape[0]
    n_gibbs = max(1, int(n * gibbs_frac))
    w_kw = dict(batch_size=batch_size, epsilon=epsilon, sigma_prop=sigma_prop, exact=False)

    def alpha_b(gen, state):
        return batched_mh_alpha(gen, state, cfg)

    def z_b(gen, state):
        k = state.z.shape[0]
        keys = torch.rand((k, n), generator=gen, dtype=torch.float64, device=state.z.device)
        pts = torch.argsort(keys, dim=-1, stable=True)[:, :n_gibbs]  # a permutation's prefix
        return batched_gibbs_z_steps(gen, state, data, cfg, pts)

    def w_run(gen, state, one_replica):
        infos = []
        for _ in range(w_moves):
            state, info = _w_move(gen, state, data, cfg, one_replica=one_replica, **w_kw)
            infos.append(info)
        return state, WMoveInfo(*(torch.stack(f, -1) for f in zip(*infos)))

    def one(fn):
        return lambda gen, state: _unbatch(fn(gen, _batch(state)))

    return cycle([
        SweepOp(one(alpha_b), name="alpha", batched_fn=alpha_b),
        SweepOp(one(z_b), name="z", batched_fn=z_b),
        SweepOp(one(lambda gen, state: w_run(gen, state, True)), name="w", has_info=True,
                batched_fn=lambda gen, state: w_run(gen, state, False)),
    ])


def _collect_summary(state: JDPMState):
    return {
        "alpha": state.alpha,
        "k_active": (state.stats.n > 0.5).sum(-1).to(torch.int32),
        "w": state.w,
    }


def _on_device(data: JDPMData, dev) -> JDPMData:
    moved = [None if t is None else t.to(dev) for t in data]
    return JDPMData(*moved[:4], moved[4] if moved[4] is not None else augment(moved[0]))


def run_posterior_sequential(seed, data: JDPMData, cfg: JDPMConfig, num_cycles: int = 30, *,
                             state0: JDPMState | None = None, collect=None, device=None,
                             **cycle_kw):
    """One replica of the full program, cycle after cycle. ``seed`` is an
    int or a generator on ``device``; without ``state0`` the initial state
    is drawn from it first. Returns ``(state_final, samples, infos)``:
    samples stacked over cycles, ``infos["w"]`` a :class:`WMoveInfo` of
    (num_cycles, w_moves) leaves."""
    dev = resolve_device(device)
    data = _on_device(data, dev)
    gen = make_generator(seed, dev)
    if state0 is None:
        state0 = init_state(gen, data, cfg)
    cyc = make_inference_cycle(data, cfg, **cycle_kw)
    return run_cycle_sequential(gen, state0, cyc, num_cycles, collect or _collect_summary,
                                device=dev)


def run_posterior_ensemble(seed, data: JDPMData, cfg: JDPMConfig, num_chains: int = 4,
                           num_cycles: int = 30, *, state0: JDPMState | None = None,
                           collect=None, device=None, **cycle_kw):
    """K independent replicas of the program on the lock-step ensemble: one
    sweep launch, one alpha move and, per w move, one lock-step sequential
    test for all replicas. The replicas share one generator; an ensemble of
    one replica reproduces :func:`run_posterior_sequential` bit for bit
    with the same seed (and the same ``state0``).

    Returns ``(state, samples, infos, diagnostics)``: samples and infos with
    leading (K, num_cycles) axes; ``diagnostics`` has the per-replica w-move
    acceptance, the mean evaluated fraction n_evaluated / N_k and the final
    number of active clusters per replica."""
    dev = resolve_device(device)
    data = _on_device(data, dev)
    gen = make_generator(seed, dev)
    if state0 is None:
        state0 = init_state(gen, data, cfg)
    cyc = make_inference_cycle(data, cfg, **cycle_kw)
    ens = ChainEnsemble(num_chains=num_chains, transition=cyc,
                        collect=collect or _collect_summary, device=dev)
    state, samples, infos = ens.run(gen, ens.init(state0), num_cycles)
    w_info = infos["w"]
    n_k = w_info.n_k.double().clamp_min(1.0)
    diagnostics = {
        "w_accept_rate": w_info.accepted.double().mean((1, 2)).cpu().numpy(),
        "w_frac_evaluated": float((w_info.n_evaluated.double() / n_k).mean()),
        "k_active_final": samples["k_active"][:, -1].cpu().numpy(),
    }
    return state, samples, infos, diagnostics


def cluster_predictive(draws, xs: torch.Tensor, prior: NIWPrior) -> torch.Tensor:
    """p(y=+1 | x*) under the mixture-of-experts posterior predictive of
    every draw: ``draws`` holds (S, ...) leaves ``w`` (S, K_max, D+1) and
    ``stats`` (a :class:`ClusterStats` over (S, K_max)); xs (B, D) ->
    (S, B). The predictive factors each draw's clusters once for all rows
    (:func:`repro_torch.inference.niw.predictive_rows`)."""
    stats, w = draws["stats"], draws["w"]
    counts = stats.n[:, None]  # (S, 1, K)
    feat = predictive_rows(xs, stats, prior)  # (S, B, K)
    logw = torch.where(counts > 0.5, torch.log(torch.clamp_min(counts, 1e-12)) + feat,
                       torch.tensor(-math.inf, device=xs.device))
    resp = torch.softmax(logw, -1)
    p_k = torch.sigmoid(torch.matmul(augment(xs), w.transpose(-1, -2)))  # (S, B, K)
    return (resp * p_k).sum(-1)


def make_serving_workload(*, smoke: bool = False, num_chains: int = 4, n: int | None = None,
                          cfg: JDPMConfig | None = None, batch_size: int = 100,
                          epsilon: float = 0.2, w_moves: int | None = None,
                          gibbs_frac: float = 0.25, seed: int = 0, device=None):
    """The joint DP mixture as a servable workload: the full Sec-4.2 cycle
    (alpha-MH + Gibbs-z + dynamic-pool subsampled-MH w moves) kept resident.
    The collected draws are the predictive sufficient state (expert
    weights, NIW cluster statistics and alpha), not the O(N) assignments,
    so the window stays small. Request classes:

      * ``cluster_predictive``: p(y=+1 | x*) under the mixture-of-experts
        posterior predictive; rows are feature points,
      * ``k_active``: posterior mean number of active clusters (rows are
        dummies; a scalar functional per draw).

    Data and the initial state come from one generator seeded with ``seed``.
    """
    from ..serving.resident import QuerySpec
    from ..serving.workloads import ServingWorkload, row_sampler

    dev = resolve_device(device)
    n = n if n is not None else (600 if smoke else 5_000)
    cfg = cfg or JDPMConfig()
    w_moves = w_moves if w_moves is not None else (2 if smoke else 8)
    gen = make_generator(seed, dev)
    data = synth(gen, n=n, n_test=max(256, n // 8), device=dev)
    cyc = make_inference_cycle(data, cfg, batch_size=min(batch_size, n), epsilon=epsilon,
                               w_moves=w_moves, gibbs_frac=gibbs_frac)

    def collect_predictive(state: JDPMState):
        return {"w": state.w, "alpha": state.alpha, "stats": state.stats}

    ens = ChainEnsemble(num_chains=num_chains, transition=cyc, collect=collect_predictive,
                        device=dev)
    prior = cfg.niw_prior(dev)
    make_points = row_sampler(data.x_test)
    specs = {
        "cluster_predictive": QuerySpec(
            fn=lambda draws, xs: cluster_predictive(draws, xs, prior), aggregate="mean",
            make_queries=make_points, name="cluster_predictive"),
        "k_active": QuerySpec(
            fn=lambda draws, xs: (draws["stats"].n > 0.5).sum(-1).to(F32)[:, None].expand(
                -1, xs.shape[0]),
            aggregate="mean", make_queries=make_points, name="k_active"),
    }
    return ServingWorkload(name="jointdpm", ensemble=ens, theta0=init_state(gen, data, cfg),
                           query_specs=specs, default_class="cluster_predictive",
                           description=f"joint DP mixture of logistic experts, N={n}")


# ---------------------------------------------------------------------------
# Posterior predictive classification
# ---------------------------------------------------------------------------


def predict_proba(state: JDPMState, x_test: torch.Tensor, cfg: JDPMConfig) -> torch.Tensor:
    """p(y=+1 | x*) under one posterior sample: mixture-weighted experts,
    x_test (T, D) -> (T,)."""
    prior = cfg.niw_prior(x_test.device)
    counts = state.stats.n
    feat = predictive_all_clusters(x_test, state.stats, prior)  # (T, K_max)
    logw = torch.where(counts > 0.5, torch.log(torch.clamp_min(counts, 1e-12)) + feat,
                       torch.tensor(-math.inf, device=x_test.device))
    resp = torch.softmax(logw, -1)
    p_k = torch.sigmoid(augment(x_test) @ state.w.T)
    return (resp * p_k).sum(-1)


def accuracy(prob, y_test) -> float:
    prob = prob.detach().cpu().numpy() if isinstance(prob, torch.Tensor) else np.asarray(prob)
    y = y_test.detach().cpu().numpy() if isinstance(y_test, torch.Tensor) else np.asarray(y_test)
    pred = np.where(prob > 0.5, 1.0, -1.0)
    return float(np.mean(pred == y))
