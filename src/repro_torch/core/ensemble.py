"""K independent MH chains advanced together: the port of
``repro.core.ensemble.ChainEnsemble``.

Every leaf of theta and of the sampler state carries a leading (K,) chain
axis. Two stepping modes share the (K, m) rounds:

  ``lockstep``  a transition proposes for all K chains at once, then runs one
      sequential-test loop whose rounds are (K, m) blocks (one draw, one
      evaluation and one round op per round) until the slowest chain's test
      stops. Finished chains keep their state, as in the reference's batched
      while loop (``_make_batched_transition``, whose structure this follows).
      A step costs ``max_k rounds_k`` rounds.
  ``masked``  the masked-continuation superstep (the reference's
      ``_run_masked_jit``): one host loop over supersteps, each one round for
      every chain with a transition in flight. A chain whose test finishes
      commits its transition and starts the next at the following superstep,
      so a run costs ``max_k sum_t rounds_{k,t}`` supersteps instead of
      ``sum_t max_k rounds_{k,t}`` rounds. The host reads the round's ``done``
      flags once per superstep; that one copy says which chains commit, which
      start, and whether all are through.

``schedule=ScheduleConfig(...)`` attaches the adaptive per-chain controller
(:mod:`repro_torch.core.schedule`) in either mode: each transition runs with
its chain's epsilon and effective batch (rounds shaped by the largest
bucket, drawn by the bounded samplers), and each completed transition
updates that chain's controller, which ``run`` returns in
``EnsembleState.controller`` so that a second ``run`` continues it.

Routes, by ``fused_kernels``:

  ``"auto"`` / ``"always"``  each round through ``target.log_local_ensemble``
      and the round op with that dispatch mode: the hand kernels on the
      card (``"always"`` raises for CPU tensors);
  ``"never"``  the same rounds through the batched plain PyTorch versions.

A target without ``log_local_ensemble`` is scored chain by chain with
``log_local``. The ensemble's callables get theta with its chain axis, so
``target.log_global`` must return (K,) for (K, ...) thetas.

``transition=cycle(...)`` (:mod:`repro_torch.core.composite`) replaces the
single (target, proposal) pair with a composite cycle: each engine
transition applies every component once, in order. A subsampled-MH op runs
the lock-step transition above with its own target, proposal, config and
batched sampler state; a sweep op calls its ``batched_fn`` on the whole
batch when it has one, and its ``fn`` chain by chain otherwise. Infos are
then a dict keyed by component name. Cycles run lock-step and unscheduled.

Randomness: one device ``torch.Generator`` per ``run`` draws all K chains'
noise each step (u, then the proposal, then the sampler; for a cycle, each
component's draws in cycle order). An ensemble of one chain therefore
reproduces :func:`repro_torch.core.chain.run_chain`, and with a cycle
:func:`repro_torch.core.composite.run_cycle_sequential`, with the same seed.
Masked stepping keeps lock-step's draws where it can: with the ``stream``
sampler the rounds draw nothing, so the generator's state at the start of
lock-step's step t is fixed; the superstep records it the first time a
chain draws step t - 1 and restores it for every chain that starts step t,
drawing the full (K,) u and proposal and keeping that chain's rows.
Masked then equals lock-step bit for bit (samples and every info field), and
leaves the generator where lock-step leaves it. With the Fisher–Yates
sampler the rounds draw from the same generator, so the superstep draws
each start's u and proposal where the stream stands: masked and lock-step
agree in distribution only (for K = 1 they coincide, and equal
``run_chain``).

Resuming: the reference resumes through ``step_keys``, where
``fold_in(chain_key, t)`` keys step t whatever the chunking. Here the
resumable schedule is the generator itself: ``run(gen, state, n)`` continues
the stream of the generator it is given, so runs of n1, n2, ... steps on one
generator equal one run of n1 + n2 + ... steps bit for bit, in lock-step with
either sampler and masked with the ``stream`` sampler (with or without a
schedule). Masked with Fisher–Yates draws its rounds from the same stream
and a chunk boundary moves where chains start their steps, so chunked and
one-shot runs agree in distribution only. The serving layer's
``ResidentEnsemble`` refreshes this way. The reference's "chain k equals a
sequential run with key k" rests on splittable keys and stays a deliberate
divergence: here the K chains share one generator.

The mesh (``shard=``): one process drives an array of slots
(:mod:`repro_torch.distributed`; by default one a visible device of the
ensemble's device type, N within ``force_devices(N)``). ``shard="auto"`` or
``True`` spreads the chains over a 1-d chain mesh of every slot (``"auto"``
only when K divides the slot count and no slot is a card, below);
``shard=("chains", "data")``, or a dict
of axis sizes, makes a 2-d chains x data mesh (the balanced default: the
divisor of n nearest sqrt(n) that also divides K). Only each round's
evaluation is split: slot (i, j) scores rows i and columns j of the (K, m)
index block, with its rows of theta and theta', on its device, and the
deltas are assembled whole on the home device. The generator's draws, the
round op, the accept and the controller stay whole on the home device, so
a sharded run is bit for bit the unsharded run (samples and every info
field) in both stepping modes, with or without a schedule, for either
sampler. A dim the mesh axis does not divide stays whole, and the first
slot of that axis scores it (``resolve_spec``'s divisibility fallback).
The reference's 1-d chain mesh runs its vmapped scan under ``shard_map``;
this one runs the family's kernel on each slot, as the 2-d mesh does,
because no plain version runs on the card. A target built by
``build_target`` on tensors places its pools on each slot device; a closure
target, or a callable pool, is scored in place, on the home device, and on
slots of other devices ``"auto"`` runs it unsharded while an explicit
request raises. Masked stepping shards on the 2-d mesh only, and composite
cycles run unsharded, as in the reference.

What ``"auto"`` decides: it builds the chain mesh only when no slot is a
card (CPU slots, ``force_devices(N)``), as the reference does over its
devices; on cards it runs unsharded, because the mesh was slower there for
every family measured. Each slot adds a wrapper call and block copies,
about 100 µs of host a slot a round, while a round's kernels take µs; and a
slot's CE launch splits the vocabulary as the whole round's launch does
(which keeps the bits), so four cards each run a quarter of one card's
blocks in about the whole round's time. On four NVIDIA H100 80GB HBM3
cards (700 W, one slot a card; ``tools/phase_cards.py`` and
``tests/test_torch_cuda.py::test_shard_auto_against_unsharded_on_cards``)
BayesLR at K=32 ran at 0.28-0.67x the unsharded transitions/s and the
``ce`` family at J's shape (K=8 per-chain (65 024, 4 096) tables) at
0.93-1.02x, copying 12.8 GB of theta and theta' rows between cards a
transition; four slots of one card ran BayesLR at 0.34-0.75x (PERF.md §5
X). An explicit ``shard=True``, ``(chains, data)`` tuple or dict still
builds the mesh, on cards too; both routes give the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .._device import (make_generator, resolve_device, to_leaf, tree_leaves, tree_map,
                      tree_select)
from ..distributed import sharding
from ..distributed.slots import visible_slots
from .chain import _stack
from .composite import CycleOp, SubsampledMHOp, init_cycle_samplers
from .mh import MHInfo
from .proposals import propose
from .samplers import batch_sampler_state, make_bounded_draw, make_sampler, sampler_fns
from .schedule import ScheduleConfig, controller_init, controller_params, controller_update
from .subsampled_mh import (
    SubsampledMHConfig,
    SubsampledMHInfo,
    adaptive_max_rounds,
    draw_log_u,
    propose_and_mu0,
    finish_transition,
)
from .target import PartitionedTarget
from ..kernels import ops

Params = Any


class EnsembleState(NamedTuple):
    """Per-chain carried state; every leaf has a leading (K,) chain axis.
    ``controller`` is ``None`` without a schedule, otherwise the batched
    :class:`repro_torch.core.schedule.ControllerState`."""

    theta: Params
    sampler_state: Any  # batched sampler state (None for the exact kernel)
    controller: Any = None

    @property
    def num_chains(self) -> int:
        return tree_leaves(self.theta)[0].shape[0]


def _takes_scale(proposal) -> bool:
    """Does ``proposal`` accept a third ``scale`` argument (the reference's
    test for ``adapt_proposal``)? Keyword-only parameters (MALA's
    ``batch_ndim``) do not count."""
    import inspect

    try:
        params = inspect.signature(proposal).parameters
    except (TypeError, ValueError):  # builtins etc: trust the caller
        return True
    positional = [p for p in params.values() if p.kind is not inspect.Parameter.KEYWORD_ONLY]
    return len(positional) >= 3 or any(
        p.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        for p in params.values())


# The masked superstep packs a transition's info into one float32 row per
# chain (one indexed write per commit): the fields are float32, bool, or
# integers below 2^24 (count is float32 in the Welford state already).
_INFO_FIELDS = SubsampledMHInfo._fields
_INFO_DTYPES = dict(accepted=torch.bool, n_evaluated=torch.int32, rounds=torch.int32,
                    batch_eff=torch.int32)


@dataclasses.dataclass(frozen=True)
class ChainEnsemble:
    """K independent MH chains advanced together.

        ens = ChainEnsemble(target, RandomWalk(0.05), num_chains=16)
        state = ens.init(theta0)                      # broadcast K chains
        state, samples, infos = ens.run(0, state, num_steps=1000)
        # samples: (K, num_steps, ...); infos leaves: (K, num_steps)

    ``stepping="masked"`` (subsampled kernel only) runs the
    masked-continuation superstep; ``schedule=ScheduleConfig(...)`` attaches
    the per-chain adaptive controller (both modes). ``device=None`` means
    the card (raises without one). ``shard`` is ``"auto"``, ``True`` or
    ``False`` (a 1-d chain mesh over every slot; ``"auto"`` builds it only
    when no slot is a card, the rule the module docstring gives with the
    four-card numbers that chose it), or a 2-d chains x data request,
    ``(chain_axis, data_axis)`` or a dict of axis sizes; on one slot every
    form runs unsharded.
    """

    target: PartitionedTarget | None = None
    proposal: Any = None
    num_chains: int = 1
    kernel: str = "subsampled"  # "subsampled" | "exact"
    config: SubsampledMHConfig | None = None
    chunk_size: int | None = None  # exact kernel: sections per chunk
    collect: Callable[[Params], Any] | None = None
    # "auto" | True | False: a 1-d chain mesh; or a 2-d chains x data
    # request: ("chains", "data") / {"chains": c, "data": d}
    shard: Any = "auto"
    chain_axis: str = "chains"
    data_axis: str = "data"
    stepping: str = "lockstep"  # "lockstep" | "masked" (subsampled only)
    schedule: ScheduleConfig | None = None  # adaptive per-chain controller
    fused_kernels: str = "auto"  # "auto" | "always" | "never"
    transition: Any = None
    device: Any = None

    def __post_init__(self):
        if self.kernel not in ("subsampled", "exact"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.stepping not in ("lockstep", "masked"):
            raise ValueError(f"unknown stepping {self.stepping!r}")
        if self.fused_kernels not in ("auto", "always", "never"):
            raise ValueError(f"unknown fused_kernels {self.fused_kernels!r}")
        if self.num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {self.num_chains}")
        if self._shard_2d_request is not None:
            if self.transition is not None:
                raise ValueError(
                    "composite transitions run unsharded; the 2-d shard=(chains, data) mesh "
                    "supports single-kernel ensembles only")
            if self.kernel != "subsampled":
                raise ValueError(
                    "the 2-d shard=(chains, data) mesh requires the subsampled kernel — only "
                    "its sequential-test rounds have a data axis to shard")
        if self.transition is not None:
            self._check_composite()
            self._device  # resolve now: without a card and without device= this raises
            return
        if self.schedule is not None and not isinstance(self.schedule, ScheduleConfig):
            raise TypeError(f"schedule must be a ScheduleConfig, got {self.schedule!r}")
        if self.target is None or self.proposal is None:
            raise ValueError("target and proposal are required without transition=")
        self._device  # resolve now: without a card and without device= this raises
        if self.kernel == "exact" and (self.stepping == "masked" or self.schedule):
            raise ValueError(
                "masked stepping / adaptive scheduling require the subsampled kernel "
                "(the exact kernel has no sequential test to overlap)")
        if self.schedule is not None and self.schedule.adapt_proposal \
                and not _takes_scale(self.proposal):
            raise ValueError("schedule.adapt_proposal=True needs a proposal accepting a third "
                             "`scale` argument (e.g. repro_torch.core.RandomWalk)")
        if self.stepping == "masked" and self.shard is True:
            raise ValueError("masked stepping runs unsharded; use shard='auto' or False")
        if self.fused_kernels == "always" and self.kernel == "exact":
            raise ValueError("fused_kernels='always' requires the subsampled kernel")
        if self.fused_kernels == "always" and self.target.log_local_ensemble is None:
            raise ValueError(
                "fused_kernels='always' but the target carries no log_local_ensemble "
                "(build it via repro_torch.core.build_target)"
            )
        if self.fused_kernels == "always" and self.shard is True:
            raise ValueError("fused_kernels='always' runs the (K, m) rounds unsharded; "
                             "use shard='auto' or False")
        self._mesh  # the mesh now: a request the slots cannot honour raises here

    def _check_composite(self):
        """The reference's rules for ``transition=cycle(...)``."""
        if not isinstance(self.transition, CycleOp):
            raise TypeError(f"transition must be a cycle(...), got {self.transition!r}")
        if self.target is not None or self.proposal is not None:
            raise ValueError("pass either (target, proposal) or transition=cycle(...), not both")
        if self.kernel != "subsampled" or self.config is not None or self.chunk_size is not None:
            raise ValueError(
                "composite transitions take kernel/config per component "
                "(SubsampledMHOp(..., config=)); the ensemble-level kernel=, config= "
                "and chunk_size= knobs do not apply"
            )
        if self.stepping != "lockstep":
            raise ValueError("composite transitions run in lock-step; the masked superstep "
                             "supports single-kernel ensembles only")
        if self.schedule is not None:
            raise ValueError("adaptive scheduling is not supported with composite transitions "
                             "(the controller assumes one target)")
        if self.shard is True:
            raise ValueError("composite transitions run unsharded; use shard='auto' or False")
        if self.fused_kernels == "always":
            names = self.transition.names
            missing = [names[i] for i, op in self.transition.mh_ops
                       if op.target.log_local_ensemble is None]
            if missing:
                raise ValueError(
                    f"fused_kernels='always' but composite MH components {missing} carry no "
                    "log_local_ensemble (build their targets via repro_torch.core.build_target)"
                )

    # -- derived static config -------------------------------------------

    @functools.cached_property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def _shard_2d_request(self):
        """Normalized 2-d mesh request: ``(chains_size | None, data_size |
        None)`` when ``shard`` asks for a chains x data mesh, else None."""
        s = self.shard
        if isinstance(s, (tuple, list)):
            if tuple(s) != (self.chain_axis, self.data_axis):
                raise ValueError(
                    f"tuple shard= must name the mesh axes "
                    f"({self.chain_axis!r}, {self.data_axis!r}), got {tuple(s)!r}")
            return (None, None)
        if isinstance(s, dict):
            extra = set(s) - {self.chain_axis, self.data_axis}
            if extra:
                raise ValueError(
                    f"dict shard= keys must be a subset of "
                    f"{{{self.chain_axis!r}, {self.data_axis!r}}}, got extra {sorted(extra)}")
            return (s.get(self.chain_axis), s.get(self.data_axis))
        if s not in ("auto", True, False):
            raise ValueError(
                f"shard must be 'auto', True, False, a ({self.chain_axis!r}, "
                f"{self.data_axis!r}) tuple, or a dict of axis sizes; got {s!r}")
        return None

    def _mesh_2d(self):
        """The chains x data mesh for a 2-d ``shard=`` request (None on one
        slot: the unsharded run is the same there)."""
        req = self._shard_2d_request
        if req is None:
            return None
        devices = visible_slots(self._device)
        n = len(devices)
        if n <= 1:
            return None
        c, d = req
        if c is None and d is not None:
            if n % d:
                raise ValueError(f"data axis size {d} must divide device count {n}")
            c = n // d
        if c is not None:
            d = d if d is not None else n // c
            if c * d != n:
                raise ValueError(
                    f"mesh {self.chain_axis}={c} x {self.data_axis}={d} != device count {n}")
        else:
            # Balanced default: the divisor of n nearest sqrt(n) that also
            # divides num_chains (c=1, a pure data mesh, always qualifies).
            cands = [k for k in range(1, n + 1) if n % k == 0 and self.num_chains % k == 0]
            c = min(cands, key=lambda k: (abs(k - math.sqrt(n)), -k))
            d = n // c
        if self.num_chains % c:
            raise ValueError(
                f"num_chains ({self.num_chains}) must be divisible by the "
                f"{self.chain_axis!r} mesh axis size ({c})")
        grid = np.empty(n, dtype=object)
        grid[:] = devices
        return sharding.Mesh(grid.reshape(c, d), (self.chain_axis, self.data_axis))

    def _chain_mesh(self):
        """The 1-d chain mesh of ``shard="auto"`` / ``True`` (None on one
        slot, for masked stepping, a cycle or a 2-d request). Under
        ``"auto"`` an explicit ``fused_kernels="always"`` runs the rounds
        unsharded, as the reference's fused scan does."""
        if self.shard is False or self.stepping == "masked" or self.transition is not None:
            return None
        if self._shard_2d_request is not None or self.fused_kernels == "always":
            return None
        devices = visible_slots(self._device)
        if len(devices) <= 1:
            return None
        if self.num_chains % len(devices) != 0:
            if self.shard is True:
                raise ValueError(
                    f"shard=True needs num_chains ({self.num_chains}) divisible "
                    f"by the device count ({len(devices)})")
            return None
        return sharding.Mesh(devices, (self.chain_axis,))

    @functools.cached_property
    def _mesh(self):
        """The mesh this ensemble's rounds are split over, or None. Taken
        when the ensemble is made, from the slots visible then. A target
        that cannot move (no ``TargetSpec``: a closure, a callable pool) is
        split in place when every slot is its home device; on slots of other
        devices ``shard="auto"`` runs it unsharded and a request raises."""
        if self.transition is not None:
            return None
        mesh = self._mesh_2d() if self._shard_2d_request is not None else self._chain_mesh()
        if mesh is None:
            return None
        if self.shard == "auto" and not self._auto_builds(mesh):
            return None
        home = sharding.canonical(self._device)
        away = sorted({str(d) for d in mesh.devices.flat if sharding.canonical(d) != home})
        if away and (self.target.spec is None or self.target.bind is None):
            if self.shard == "auto":
                return None
            raise ValueError(
                f"shard={self.shard!r} puts slots on {away}, but the target cannot leave its "
                f"home device {home}: it has no TargetSpec (a closure or a callable pool; "
                "build_target on tensors places its pools on every slot device)")
        return mesh

    @staticmethod
    def _auto_builds(mesh) -> bool:
        """``shard="auto"``'s rule (module docstring): the mesh is built
        only when no slot is a card."""
        return all(torch.device(d).type != "cuda" for d in mesh.devices.flat)

    @property
    def _config(self) -> SubsampledMHConfig:
        return self.config or SubsampledMHConfig()

    @functools.cached_property
    def _buckets(self) -> tuple[int, ...]:
        if self.schedule is None:
            return (self._config.batch_size,)
        return self.schedule.buckets_for(self._config, self.target.num_sections)

    @functools.cached_property
    def _bucket_table(self) -> torch.Tensor:
        """The buckets as an int32 tensor on the device, for controller_params."""
        return torch.tensor(self._buckets, dtype=torch.int32, device=self._device)

    @functools.cached_property
    def _max_rounds(self) -> int:
        return adaptive_max_rounds(self._config, self.target.num_sections, self._buckets)

    def _round_fn(self, theta, theta_p, target=None):
        """``idx (K, m) -> (K, m)`` deltas for one transition's rounds."""
        t = self.target if target is None else target
        if t.log_local_ensemble is not None:
            return t.local_round(theta, theta_p, ensemble=True, mode=self.fused_kernels)
        chains = [t.local_round(tree_map(lambda l: l[k], theta), tree_map(lambda l: l[k], theta_p))
                  for k in range(self.num_chains)]
        mesh = sharding.active_mesh()
        if mesh is None:
            return lambda idx: torch.stack([fn(idx[k]) for k, fn in enumerate(chains)])

        def score(blk, idx):  # in place: the slot's chains, each on the slot's columns
            first = blk.index[0].start
            return torch.stack([chains[first + r](row) for r, row in enumerate(idx)])

        return sharding.split_round(*mesh, self._device, score)

    # -- state ------------------------------------------------------------

    def init(self, theta0: Params, *, batched: bool = False) -> EnsembleState:
        """``theta0`` is one tree broadcast to all chains, or (``batched=True``)
        a tree whose leaves already carry the (K,) axis. Leaves become
        float32, but int32 leaves stay int32."""
        dev = self._device
        K = self.num_chains

        def place(leaf):
            leaf = to_leaf(leaf, dev)
            return leaf.clone() if batched else leaf[None].repeat((K,) + (1,) * leaf.ndim)

        theta = tree_map(place, theta0)
        lead = tree_leaves(theta)[0].shape[0]
        if lead != K:
            raise ValueError(f"theta leading axis {lead} != num_chains {K}")
        if self.transition is not None:
            samplers = tuple(
                s.repeat(K) if isinstance(s, torch.Tensor) else batch_sampler_state(s, K)
                for s in init_cycle_samplers(self.transition, device=dev))
            return EnsembleState(theta, samplers, None)
        if self.kernel == "exact":
            return EnsembleState(theta, None, None)
        state0, _, _ = make_sampler(self._config.sampler, self.target.num_sections, device=dev)
        ctrl = None
        if self.schedule is not None:
            ctrl = controller_init(self.schedule, self._config, self.target.num_sections, K,
                                   device=dev)
        return EnsembleState(theta, batch_sampler_state(state0, K), ctrl)

    # -- transitions -------------------------------------------------------

    def _mh_step(self, gen, theta, sampler, target, proposal, cfg, max_rounds,
                 prop_scale=None, **knobs):
        """One lock-step subsampled-MH transition of all K chains; ``knobs``
        are the scheduler's overrides of :func:`finish_transition`."""
        reset_fn, draw_fn = sampler_fns(cfg.sampler)
        theta_p, mu0, log_u = propose_and_mu0(gen, theta, target, proposal, prop_scale,
                                              batch_shape=(self.num_chains,))
        return finish_transition(
            gen, theta, theta_p, mu0, log_u, sampler, target, cfg, reset_fn, draw_fn,
            eval_fn=self._round_fn(theta, theta_p, target),
            max_rounds=max_rounds, mode=self.fused_kernels, **knobs,
        )

    def _subsampled_step(self, gen, theta, sampler):
        return self._mh_step(gen, theta, sampler, self.target, self.proposal, self._config,
                             self._max_rounds)

    def _prop_scale(self, ctrl):
        return ctrl.sigma_scale if self.schedule.adapt_proposal else None

    def _update_controller(self, ctrl, info):
        sched, cfg = self.schedule, self._config
        return controller_update(ctrl, info, sched, self._buckets, self.target.num_sections,
                                 sched.epsilon_floor(cfg))

    def _scheduled_step(self, gen, theta, sampler, ctrl):
        """A lock-step transition with each chain's knobs from its controller,
        then the controller update (the reference's scheduled lock-step scan).
        Returns (theta, sampler, controller, info)."""
        eps, meff = controller_params(ctrl, self._bucket_table)
        theta, sampler, info = self._mh_step(
            gen, theta, sampler, self.target, self.proposal, self._config, self._max_rounds,
            self._prop_scale(ctrl), epsilon=eps, batch_eff=meff,
            draw_bounded_fn=make_bounded_draw(self._config.sampler),
            batch_max=max(self._buckets))
        return theta, sampler, self._update_controller(ctrl, info), info

    def _sweep_op_step(self, gen, theta, op):
        """A sweep of a composite cycle: ``batched_fn`` on the whole batch, or
        ``fn`` chain by chain. Returns (theta, info or None)."""
        if op.batched_fn is not None:
            out = op.batched_fn(gen, theta)
        else:
            rows = [op.fn(gen, tree_map(lambda l: l[k], theta)) for k in range(self.num_chains)]
            out = _stack(rows)
        return out if op.has_info else (out, None)

    def _composite_step(self, gen, theta, samplers):
        """One engine transition of a cycle: every component once, in order,
        drawing from ``gen`` in cycle order. Returns (theta, samplers, infos
        keyed by component name)."""
        cyc = self.transition
        samplers, infos = list(samplers), {}
        for i, (name, op) in enumerate(zip(cyc.names, cyc.ops)):
            if isinstance(op, SubsampledMHOp):
                theta, samplers[i], infos[name] = self._mh_step(
                    gen, theta, samplers[i], op.target, op.proposal, op.cfg, op.max_rounds)
            else:
                theta, info = self._sweep_op_step(gen, theta, op)
                if op.has_info:
                    infos[name] = info
        return theta, tuple(samplers), infos

    def _exact_step(self, gen, theta, sampler):
        K, n, dev = self.num_chains, self.target.num_sections, self._device
        log_u = draw_log_u(gen, (K,), dev)
        theta_p, corr = propose(self.proposal, gen, theta, batch_ndim=1)
        g = self.target.log_global(theta, theta_p) + corr
        step = n if self.chunk_size is None or self.chunk_size >= n else self.chunk_size
        total = torch.zeros((K,), dtype=torch.float32, device=dev)
        eval_fn = self._round_fn(theta, theta_p)
        for start in range(0, n, step):
            idx = torch.arange(start, min(start + step, n), dtype=torch.int32, device=dev)
            idx = idx[None].expand(K, -1).contiguous()
            total = total + eval_fn(idx).sum(-1)
        accept = log_u < g + total
        info = MHInfo(
            accepted=accept,
            n_evaluated=torch.full((K,), n, dtype=torch.int32, device=dev),
            rounds=torch.full((K,), max(1, -(-n // step)), dtype=torch.int32, device=dev),
            mu_hat=total / n,
            mu0=(log_u - g) / n,
            log_u=log_u,
        )
        return tree_select(accept, theta_p, theta), sampler, info

    # -- drivers ----------------------------------------------------------

    def run(self, seed, state: EnsembleState, num_steps: int):
        """Advance every chain ``num_steps`` transitions. ``seed`` is an int
        or a ``torch.Generator`` on the ensemble's device (pass the same
        generator again to continue its stream). Returns ``(state, samples,
        infos)`` with leaves shaped (K, num_steps, ...)."""
        gen = make_generator(seed, self._device)
        if self._mesh is not None:
            with sharding.logical_axis_rules(self._mesh):
                return self._run(gen, state, num_steps)
        return self._run(gen, state, num_steps)

    def _run(self, gen, state: EnsembleState, num_steps: int):
        if self.stepping == "masked":
            return self._run_masked(gen, state, num_steps)
        if self.transition is not None:
            step = self._composite_step
        elif self.kernel == "subsampled":
            step = self._subsampled_step
        else:
            step = self._exact_step
        collect = self.collect or (lambda t: t)
        theta, sampler, ctrl = state
        samples, infos = [], []
        for _ in range(num_steps):
            if self.schedule is None:
                theta, sampler, info = step(gen, theta, sampler)
            else:
                theta, sampler, ctrl, info = self._scheduled_step(gen, theta, sampler, ctrl)
            samples.append(collect(theta))
            infos.append(info)
        swap = lambda t: tree_map(lambda l: l.transpose(0, 1), t)
        return EnsembleState(theta, sampler, ctrl), swap(_stack(samples)), swap(_stack(infos))

    # -- masked-continuation superstep -----------------------------------

    def _run_masked(self, gen, state: EnsembleState, num_steps: int):
        """The masked superstep loop (see the module docstring). Per chain it
        carries the transition in flight: the proposal, mu0, log u, the knobs
        frozen at its start, and the round op's state, which the round op
        updates in place (chains whose test is done are left alone)."""
        K, T, dev, cfg = self.num_chains, num_steps, self._device, self._config
        target, sched, mode = self.target, self.schedule, self.fused_kernels
        n = target.num_sections
        m_max = max(self._buckets)
        _, draw_fn = sampler_fns(cfg.sampler)
        draw_bounded = make_bounded_draw(cfg.sampler)
        collect = self.collect or (lambda t: t)
        theta, sampler, ctrl = state
        f32 = dict(dtype=torch.float32, device=dev)
        stats = torch.zeros((3, K), **f32)  # the Welford rows: count, mean, m2
        count, mean, m2 = stats
        pval = torch.ones(K, **f32)
        rounds = torch.zeros(K, dtype=torch.int32, device=dev)
        done = torch.ones(K, dtype=torch.bool, device=dev)  # no transition in flight
        decision = torch.zeros(K, dtype=torch.bool, device=dev)
        mu0, log_u = torch.zeros(K, **f32), torch.zeros(K, **f32)
        eps = torch.full((K,), cfg.epsilon, **f32)
        meff = torch.full((K,), cfg.batch_size, dtype=torch.int32, device=dev)
        theta_prop = theta
        samples = tree_map(lambda l: l.new_empty((K, T) + l.shape[1:]), collect(theta))
        info_rows = torch.empty((K, T, len(_INFO_FIELDS)), **f32)
        steps = np.zeros(K, np.int64)  # transitions committed, per chain (host)
        in_flight = np.zeros(K, bool)
        # stream sampler: the generator's state at the start of each step
        step_states = {0: gen.get_state()} if cfg.sampler == "stream" else None
        start = np.full(K, T > 0)
        while True:
            if start.any():
                start_t = torch.as_tensor(start, device=dev)
                theta_prop, mu0, log_u = self._masked_proposals(
                    gen, start, start_t, steps, step_states, theta, theta_prop, mu0, log_u, ctrl)
                if sched is not None:
                    eps_n, meff_n = controller_params(ctrl, self._bucket_table)
                    eps, meff = torch.where(start_t, eps_n, eps), torch.where(start_t, meff_n, meff)
                stats.masked_fill_(start_t, 0.0)
                pval.masked_fill_(start_t, 1.0)
                rounds.masked_fill_(start_t, 0)
                done.masked_fill_(start_t, False)
                decision.masked_fill_(start_t, False)
                sampler = sampler._replace(pos=sampler.pos.masked_fill(start_t, 0))
                in_flight |= start
                eval_fn = self._round_fn(theta, theta_prop)
            if not in_flight.any():
                break
            # one sequential-test round for every chain with a test in flight
            if sched is None:
                sampler, idx, valid = draw_fn(gen, sampler, m_max, ~done, mode=mode)
            else:
                sampler, idx, valid = draw_bounded(gen, sampler, m_max, meff, ~done, mode=mode)
            ops.t_test_round(eval_fn(idx), valid, count, mean, m2, mu0, eps, n,
                             self._max_rounds, rounds, done, decision, pval, mode=mode)
            fin = done.cpu().numpy() & in_flight  # the superstep's one read
            if fin.any():
                rows = np.flatnonzero(fin)
                h = torch.as_tensor(np.concatenate([fin, rows, steps[rows]]), device=dev)
                fin_t, r, c = h[:K].bool(), h[K:K + len(rows)], h[K + len(rows):]
                theta = tree_select(decision & fin_t, theta_prop, theta)
                tree_map(lambda buf, v: buf.index_put_((r, c), v.index_select(0, r)),
                         samples, collect(theta))
                info = SubsampledMHInfo(decision, count, rounds, mean, mu0, pval, log_u, eps,
                                        meff)
                info_rows.index_put_((r, c), torch.stack(info, -1).index_select(0, r))
                if sched is not None:
                    info = info._replace(n_evaluated=count.to(torch.int32))
                    ctrl = tree_select(fin_t, self._update_controller(ctrl, info), ctrl)
                steps += fin
                in_flight &= ~fin
            start = fin & (steps < T)
        if step_states is not None and T > 0:
            gen.set_state(step_states[T])  # where lock-step leaves it
        infos = SubsampledMHInfo(*(
            col.to(_INFO_DTYPES.get(name, torch.float32)).contiguous()
            for name, col in zip(_INFO_FIELDS, info_rows.unbind(-1))))
        return EnsembleState(theta, sampler, ctrl), samples, infos

    def _masked_proposals(self, gen, start, start_t, steps, step_states, theta, theta_prop,
                          mu0, log_u, ctrl):
        """u, the proposal and mu0 for the chains that start a transition.
        With the stream sampler each chain draws from the generator state of
        its step (recorded after that step's first draws), as lock-step
        does; otherwise all draws come from where the stream stands."""
        K, dev = self.num_chains, self._device
        scale = None if self.schedule is None else self._prop_scale(ctrl)
        groups = [(start_t, None)] if step_states is None else [
            (start_t if (steps[start] == s).all() else
             torch.as_tensor(start & (steps == s), device=dev), int(s))
            for s in np.unique(steps[start])]
        for sel, s in groups:
            if s is not None:
                gen.set_state(step_states[s])
            th_p, mu0_n, log_u_n = propose_and_mu0(gen, theta, self.target, self.proposal,
                                                   scale, batch_shape=(K,))
            if s is not None:
                step_states.setdefault(s + 1, gen.get_state())
            theta_prop = tree_select(sel, th_p, theta_prop)
            mu0, log_u = torch.where(sel, mu0_n, mu0), torch.where(sel, log_u_n, log_u)
        return theta_prop, mu0, log_u

    def run_timed(self, seed, state: EnsembleState, num_steps: int, block_every: int = 1, *,
                  start_step: int = 0, on_block=None):
        """Host-chunked loop recording the wall clock, synchronising the
        device after every block. One warm-up transition on a copy of the
        state (with its own generator) builds the kernels outside the timed
        window. ``seed`` is an int or a generator: pass the same generator
        and the returned state again to continue one run bit for bit.
        ``on_block(state, samples, infos, steps_done)`` (optional) runs after
        every block inside the timed window; ``steps_done`` counts from
        ``start_step``, which only numbers the steps (the generator carries
        the schedule). Returns (state, dict) with ``transitions_per_sec``
        summed over chains and ``next_step``, ``start_step + num_steps``."""
        gen = make_generator(seed, self._device)
        dev_sync = torch.cuda.synchronize if self._device.type == "cuda" else (lambda: None)
        warm = tree_map(lambda l: l.clone() if isinstance(l, torch.Tensor) else l, state)
        self.run(make_generator(0, self._device), warm, 1)
        dev_sync()
        samples_blocks, infos_blocks = [], []
        t0 = time.perf_counter()
        done = 0
        while done < num_steps:
            n = min(block_every, num_steps - done)
            state, samples, infos = self.run(gen, state, n)
            dev_sync()
            samples_blocks.append(samples)
            infos_blocks.append(infos)
            done += n
            if on_block is not None:
                on_block(state, samples, infos, start_step + done)
        wall = time.perf_counter() - t0
        cat = lambda blocks: tree_map(lambda *ls: torch.cat(ls, dim=1), *blocks)
        return state, {
            "samples": cat(samples_blocks),
            "infos": cat(infos_blocks),
            "wall": wall,
            "transitions_per_sec": self.num_chains * num_steps / max(wall, 1e-12),
            "next_step": start_step + num_steps,
        }


def run_ensemble(seed, theta0: Params, target: PartitionedTarget, proposal, num_chains: int,
                 num_steps: int, kernel: str = "subsampled",
                 config: SubsampledMHConfig | None = None, **kw):
    """One-shot wrapper: init + run. Returns (state, samples, infos)."""
    ens = ChainEnsemble(target, proposal, num_chains, kernel=kernel, config=config, **kw)
    return ens.run(seed, ens.init(theta0), num_steps)
