"""The ensemble pool: configuration, freshness policy and persistence, the
port of ``repro.serving.pool``.

An :class:`EnsemblePool` owns one :class:`~repro_torch.serving.resident.ResidentEnsemble`
per registered workload and stands between requests and residents:

  * every query goes through :meth:`EnsemblePool.query`, which first runs
    the :class:`FreshnessPolicy`: a snapshot is served only if it is young
    enough (``max_staleness_s``), deep enough (``min_draws``) and, when
    configured, mixed enough (``min_ess``, ``max_rhat``); a stale snapshot
    triggers synchronous refreshes until the policy admits one;
  * :meth:`save` / :meth:`restore` persist every resident's sampler state,
    controller, step counter, generator state and posterior window through
    :mod:`repro_torch.checkpoint.manager`, so a restarted pool resumes warm:
    no re-burn-in, and its next refresh continues the generator stream the
    original process was on;
  * :meth:`start` / :meth:`stop` run the residents' background refresh
    threads for always-on serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..checkpoint import manager as ckpt
from ..core.stats import multichain_ess, split_rhat
from .resident import QuerySpec, ResidentEnsemble, Snapshot
from .workloads import ServingWorkload, build_serving_workload


@dataclasses.dataclass(frozen=True)
class FreshnessPolicy:
    """When is a snapshot servable?

    ``max_staleness_s``: the newest draw must be younger than this;
    ``min_draws``: the window must hold at least this many cross-chain
    draws (K x window depth);
    ``min_ess``: optional floor on the window's total effective sample
    size, computed on a scalar functional of the draws (the first component
    of the first leaf);
    ``max_rhat``: optional online-convergence gate: the window's cross-chain
    split-R-hat on the same scalar must be at or below this. A window too
    short to split (fewer than 4 draws per chain) counts as stale.
    """

    max_staleness_s: float = 30.0
    min_draws: int = 64
    min_ess: float | None = None
    max_rhat: float | None = None

    def stale_reason(self, snap: Snapshot) -> str | None:
        """None if servable, else a human-readable refusal."""
        if snap.draws is None:
            return "no draws yet"
        if snap.num_draws < self.min_draws:
            return f"only {snap.num_draws}/{self.min_draws} draws"
        if snap.staleness_s > self.max_staleness_s:
            return f"stale by {snap.staleness_s:.3f}s > {self.max_staleness_s}s"
        if self.min_ess is not None:
            ess = snapshot_ess(snap)
            if ess < self.min_ess:
                return f"window ESS {ess:.1f} < {self.min_ess}"
        if self.max_rhat is not None:
            rhat = snapshot_rhat(snap)
            if rhat is None:
                return "window too short for split-R-hat (need >= 4 draws/chain)"
            if not rhat <= self.max_rhat:  # NaN R-hat must read as stale
                return f"window R-hat {rhat:.4f} > {self.max_rhat}"
        return None

    def is_fresh(self, snap: Snapshot) -> bool:
        return self.stale_reason(snap) is None


def _first_leaf(tree: Any):
    """The first leaf in the reference's pytree order (dict keys sorted)."""
    while True:
        if isinstance(tree, dict):
            tree = tree[sorted(tree)[0]]
        elif isinstance(tree, (tuple, list)):
            tree = tree[0]
        else:
            return tree


def _scalar_trace(snap: Snapshot) -> np.ndarray:
    leaf = np.asarray(_first_leaf(snap.draws), np.float64)
    k, w = leaf.shape[:2]
    return leaf.reshape(k, w, -1)[:, :, 0]


def snapshot_ess(snap: Snapshot) -> float:
    """Total cross-chain ESS of a scalar trace of the window draws."""
    trace = _scalar_trace(snap)
    if trace.shape[1] < 4:
        return 0.0
    return multichain_ess(trace)


def snapshot_rhat(snap: Snapshot) -> float | None:
    """Rolling-window split-R-hat of the scalar trace ``snapshot_ess`` uses,
    or None when the window is too short to split into half-chains."""
    if snap.draws is None:
        return None
    trace = _scalar_trace(snap)
    if trace.shape[1] < 4:
        return None
    return float(split_rhat(trace))


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Pool-wide serving knobs (per-workload overrides go through
    ``add_workload(..., **build_kw)``). ``device=None`` means the card."""

    num_chains: int = 8
    refresh_steps: int = 32  # transitions per refresh block
    window: int = 64  # posterior draws retained per chain
    micro_batch: int = 64  # request rows per evaluation
    max_batch: int = 16  # requests coalesced into one evaluation
    freshness: FreshnessPolicy = FreshnessPolicy()
    default_deadline_s: float = 1.0
    background_interval_s: float = 0.0  # pause between background refreshes
    max_refreshes_per_query: int = 64  # freshness-loop safety bound
    seed: int = 0
    device: Any = None


class EnsemblePool:
    """Named resident ensembles behind one freshness-enforcing query API."""

    def __init__(self, config: ServingConfig | None = None):
        self.config = config or ServingConfig()
        self._workloads: dict[str, ServingWorkload] = {}
        self._residents: dict[str, ResidentEnsemble] = {}

    # -- registration ------------------------------------------------------

    def add_workload(self, workload: str | ServingWorkload, *, seed: int | None = None,
                     **build_kw) -> ResidentEnsemble:
        """Build (or adopt) a workload and give it a resident ensemble.

        ``seed`` overrides the resident's chain seed (default
        ``config.seed``), which seeds its generator: independent chain
        trajectories over the same data. A workload named by string is built
        with ``num_chains``, ``seed`` (its data's) and ``device`` from the
        config unless ``build_kw`` says otherwise.
        """
        cfg = self.config
        if isinstance(workload, str):
            build_kw.setdefault("num_chains", cfg.num_chains)
            build_kw.setdefault("seed", cfg.seed)
            build_kw.setdefault("device", cfg.device)
            workload = build_serving_workload(workload, **build_kw)
        name = workload.name
        if name in self._residents:
            raise ValueError(f"workload {name!r} already resident in this pool")
        resident = ResidentEnsemble(
            workload.ensemble,
            workload.theta0,
            seed=cfg.seed if seed is None else seed,
            window=cfg.window,
            refresh_steps=cfg.refresh_steps,
            micro_batch=cfg.micro_batch,
            name=name,
        )
        self._workloads[name] = workload
        self._residents[name] = resident
        return resident

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._residents))

    def resident(self, name: str) -> ResidentEnsemble:
        return self._residents[name]

    def workload(self, name: str) -> ServingWorkload:
        return self._workloads[name]

    def spec(self, name: str, query_class: str) -> QuerySpec:
        return self._workloads[name].query_specs[query_class]

    # -- freshness ---------------------------------------------------------

    def ensure_fresh(self, name: str) -> Snapshot:
        """Refresh ``name`` until its snapshot passes the freshness policy;
        returns the admitted snapshot."""
        resident = self._residents[name]
        policy = self.config.freshness
        snap = resident.snapshot()
        refreshes = 0
        while not policy.is_fresh(snap):
            if refreshes >= self.config.max_refreshes_per_query:
                raise RuntimeError(f"freshness unreachable for {name!r} after {refreshes} "
                                   f"refreshes: {policy.stale_reason(snap)}")
            resident.refresh()
            refreshes += 1
            snap = resident.snapshot()
        return snap

    def warm(self) -> None:
        """Bring every resident to a servable snapshot (initial burn)."""
        for name in self.names():
            self.ensure_fresh(name)

    def append_observations(self, name: str, new_data) -> int:
        """Fold newly appended observations into ``name``'s running chains
        (:meth:`ResidentEnsemble.append`). The resident's window then reads
        as stale, so the next query refreshes against the grown posterior."""
        return self._residents[name].append(new_data)

    # -- queries -----------------------------------------------------------

    def query(self, name: str, query_class: str, xs, *, snapshot: Snapshot | None = None,
              span_sink: list | None = None) -> tuple[np.ndarray, Snapshot]:
        """Freshness-checked posterior-functional evaluation; returns
        ``(values, snapshot_used)``. An explicit ``snapshot`` (pinned by the
        request queue for a whole batch) skips the freshness round trip."""
        spec = self.spec(name, query_class)
        if snapshot is None:
            snapshot = self.ensure_fresh(name)
        return self._residents[name].query(spec, xs, snapshot=snapshot, span_sink=span_sink)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for resident in self._residents.values():
            resident.start_background(self.config.background_interval_s)

    def stop(self) -> None:
        for resident in self._residents.values():
            resident.stop_background()

    # -- persistence -------------------------------------------------------

    def save(self, ckpt_dir: str, keep: int = 3) -> str:
        """Atomically persist every resident (state, generator, window)."""
        state = {"residents": {name: res.state_dict() for name, res in self._residents.items()}}
        step = max((r.steps_done for r in self._residents.values()), default=0)
        return ckpt.save(ckpt_dir, step, state, keep=keep)

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        """Restore residents saved by :meth:`save` into this pool's
        (identically configured) residents. Returns the checkpoint step."""
        step_loaded, flat = ckpt.restore(ckpt_dir, step=step)
        for name, resident in self._residents.items():
            prefix = f"residents__{name}__"
            sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
            if not sub:
                raise KeyError(f"checkpoint {ckpt_dir} has no state for resident {name!r}")
            resident.load_flat(sub)
        return step_loaded

    def slo_snapshot_report(self) -> dict:
        """Per-resident snapshot ages and depths (dashboards and smoke)."""
        out = {}
        for name in self.names():
            snap = self._residents[name].snapshot()
            out[name] = {"staleness_s": snap.staleness_s, "num_draws": snap.num_draws,
                         "steps_done": snap.steps_done,
                         "fresh": self.config.freshness.is_fresh(snap)}
        return out
