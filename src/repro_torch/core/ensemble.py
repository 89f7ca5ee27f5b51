"""K independent MH chains in lock-step: the port of
``repro.core.ensemble.ChainEnsemble`` (lock-step stepping).

Every leaf of theta and of the sampler state carries a leading (K,) chain
axis. A transition proposes for all K chains at once, then runs one
sequential-test loop whose rounds are (K, m) blocks: one draw, one
evaluation and one round op per round, until the slowest chain's test stops.
Finished chains keep their state, as in the reference's batched while loop
(``_make_batched_transition``, whose structure this follows).

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
then a dict keyed by component name.

Randomness: one device ``torch.Generator`` per ``run`` draws all K chains'
noise each step (u, then the proposal, then the sampler; for a cycle, each
component's draws in cycle order). An ensemble of one chain therefore
reproduces :func:`repro_torch.core.chain.run_chain`, and with a cycle
:func:`repro_torch.core.composite.run_cycle_sequential`, with the same seed.
The reference's "chain k equals a sequential run with key k" and its
resumable ``step_keys`` schedule rest on JAX's splittable keys and wait for
the serving slice. So do ``stepping="masked"`` and ``schedule=`` for single
kernels; the ``shard=`` mesh paths wait for the distributed slice. Each
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, NamedTuple

import torch

from .._device import make_generator, resolve_device, tree_leaves, tree_map, tree_select
from .chain import _stack
from .composite import CycleOp, SubsampledMHOp, init_cycle_samplers
from .mh import MHInfo
from .samplers import batch_sampler_state, make_sampler, sampler_fns
from .subsampled_mh import (
    SubsampledMHConfig,
    adaptive_max_rounds,
    draw_log_u,
    propose_and_mu0,
    finish_transition,
)
from .target import PartitionedTarget

Params = Any


class EnsembleState(NamedTuple):
    """Per-chain carried state; every leaf has a leading (K,) chain axis."""

    theta: Params
    sampler_state: Any  # batched sampler state (None for the exact kernel)
    controller: Any = None  # the adaptive scheduler's state, in a later slice

    @property
    def num_chains(self) -> int:
        return tree_leaves(self.theta)[0].shape[0]


def _later(what: str, where: str):
    raise NotImplementedError(f"{what} comes with {where}; this slice runs lock-step ensembles")


@dataclasses.dataclass(frozen=True)
class ChainEnsemble:
    """K independent MH chains advanced together in lock-step.

        ens = ChainEnsemble(target, RandomWalk(0.05), num_chains=16)
        state = ens.init(theta0)                      # broadcast K chains
        state, samples, infos = ens.run(0, state, num_steps=1000)
        # samples: (K, num_steps, ...); infos leaves: (K, num_steps)

    ``device=None`` means the card (raises without one).
    """

    target: PartitionedTarget | None = None
    proposal: Any = None
    num_chains: int = 1
    kernel: str = "subsampled"  # "subsampled" | "exact"
    config: SubsampledMHConfig | None = None
    chunk_size: int | None = None  # exact kernel: sections per chunk
    collect: Callable[[Params], Any] | None = None
    shard: Any = "auto"
    stepping: str = "lockstep"
    schedule: Any = None
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
        if self.transition is not None:
            self._check_composite()
            self._device  # resolve now: without a card and without device= this raises
            return
        if self.stepping == "masked":
            _later("stepping='masked'", "the scheduler slice")
        if self.schedule is not None:
            _later("schedule=", "the scheduler slice")
        if self.shard not in ("auto", False):
            _later(f"shard={self.shard!r}", "the distributed slice")
        if self.target is None or self.proposal is None:
            raise ValueError("target and proposal are required without transition=")
        self._device  # resolve now: without a card and without device= this raises
        if self.fused_kernels == "always" and self.kernel == "exact":
            raise ValueError("fused_kernels='always' requires the subsampled kernel")
        if self.fused_kernels == "always" and self.target.log_local_ensemble is None:
            raise ValueError(
                "fused_kernels='always' but the target carries no log_local_ensemble "
                "(build it via repro_torch.core.build_target)"
            )

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
        if self.shard not in ("auto", False):
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

    @property
    def _config(self) -> SubsampledMHConfig:
        return self.config or SubsampledMHConfig()

    @functools.cached_property
    def _max_rounds(self) -> int:
        return adaptive_max_rounds(self._config, self.target.num_sections,
                                   (self._config.batch_size,))

    def _round_fn(self, theta, theta_p, target=None):
        """``idx (K, m) -> (K, m)`` deltas for one transition's rounds."""
        t = self.target if target is None else target
        if t.log_local_ensemble is not None:
            return t.local_round(theta, theta_p, ensemble=True, mode=self.fused_kernels)
        chains = [t.local_round(tree_map(lambda l: l[k], theta), tree_map(lambda l: l[k], theta_p))
                  for k in range(self.num_chains)]
        return lambda idx: torch.stack([fn(idx[k]) for k, fn in enumerate(chains)])

    # -- state ------------------------------------------------------------

    def init(self, theta0: Params, *, batched: bool = False) -> EnsembleState:
        """``theta0`` is one tree broadcast to all chains, or (``batched=True``)
        a tree whose leaves already carry the (K,) axis."""
        dev = self._device
        K = self.num_chains

        def place(leaf):
            leaf = torch.as_tensor(leaf, dtype=torch.float32).to(dev)
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
        return EnsembleState(theta, batch_sampler_state(state0, K), None)

    # -- transitions -------------------------------------------------------

    def _mh_step(self, gen, theta, sampler, target, proposal, cfg, max_rounds):
        """One lock-step subsampled-MH transition of all K chains."""
        reset_fn, draw_fn = sampler_fns(cfg.sampler)
        theta_p, mu0, log_u = propose_and_mu0(gen, theta, target, proposal,
                                              batch_shape=(self.num_chains,))
        return finish_transition(
            gen, theta, theta_p, mu0, log_u, sampler, target, cfg, reset_fn, draw_fn,
            eval_fn=self._round_fn(theta, theta_p, target),
            max_rounds=max_rounds, mode=self.fused_kernels,
        )

    def _subsampled_step(self, gen, theta, sampler):
        return self._mh_step(gen, theta, sampler, self.target, self.proposal, self._config,
                             self._max_rounds)

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
        theta_p, corr = self.proposal(gen, theta)
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
        if self.transition is not None:
            step = self._composite_step
        elif self.kernel == "subsampled":
            step = self._subsampled_step
        else:
            step = self._exact_step
        collect = self.collect or (lambda t: t)
        theta, sampler = state.theta, state.sampler_state
        samples, infos = [], []
        for _ in range(num_steps):
            theta, sampler, info = step(gen, theta, sampler)
            samples.append(collect(theta))
            infos.append(info)
        swap = lambda t: tree_map(lambda l: l.transpose(0, 1), t)
        return EnsembleState(theta, sampler, None), swap(_stack(samples)), swap(_stack(infos))

    def run_timed(self, seed, state: EnsembleState, num_steps: int, block_every: int = 1):
        """Host-chunked loop recording the wall clock, synchronising the
        device after every block. One warm-up transition on a copy of the
        state (with its own generator) builds the kernels outside the timed
        window. Returns (state, dict) with ``transitions_per_sec`` summed
        over chains."""
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
        wall = time.perf_counter() - t0
        cat = lambda blocks: tree_map(lambda *ls: torch.cat(ls, dim=1), *blocks)
        return state, {
            "samples": cat(samples_blocks),
            "infos": cat(infos_blocks),
            "wall": wall,
            "transitions_per_sec": self.num_chains * num_steps / max(wall, 1e-12),
        }


def run_ensemble(seed, theta0: Params, target: PartitionedTarget, proposal, num_chains: int,
                 num_steps: int, kernel: str = "subsampled",
                 config: SubsampledMHConfig | None = None, **kw):
    """One-shot wrapper: init + run. Returns (state, samples, infos)."""
    ens = ChainEnsemble(target, proposal, num_chains, kernel=kernel, config=config, **kw)
    return ens.run(seed, ens.init(theta0), num_steps)
