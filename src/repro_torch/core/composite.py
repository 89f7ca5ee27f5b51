"""Composite transition operators: the paper's ``[infer (cycle (...))]``.

The port of ``repro.core.composite``. Stochastic volatility cycles a
particle-Gibbs sweep over the latent paths with per-variable subsampled-MH
moves on phi and sigma^2; this module gives that program its shape:

  :func:`cycle`           an ordered cycle of component operators,
  :class:`SubsampledMHOp` a per-variable subsampled-MH kernel (its target
                          may read latent state from ``theta``),
  :class:`SweepOp`        an opaque inner kernel ``fn(gen, theta) -> theta``
                          (or ``-> (theta, info)``), with an optional
                          natively chain-batched ``batched_fn``.

Randomness: one ``torch.Generator`` is consumed in cycle order, step after
step (each MH op draws u, its proposal and its sampler's uniforms; each
sweep draws what it needs). :func:`run_cycle_sequential` is the single-chain
driver; :class:`repro_torch.core.ensemble.ChainEnsemble` with
``transition=cycle(...)`` runs K chains in lock-step with the same
discipline, so an ensemble of one chain reproduces it with the same seed.
A cycle of one MH op draws what the bare kernel draws, so it reproduces the
bare kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import make_generator, resolve_device, to_leaf, tree_map
from .chain import _stack
from .samplers import make_sampler, sampler_fns
from .subsampled_mh import SubsampledMHConfig, adaptive_max_rounds, subsampled_mh_step
from .target import PartitionedTarget

Params = Any


@dataclasses.dataclass(frozen=True)
class SubsampledMHOp:
    """One per-variable subsampled-MH component of a composite cycle.

    The target's local sections may read latent state (the particle-Gibbs
    paths) from ``theta`` as long as ``proposal`` does not move those leaves.
    """

    target: PartitionedTarget
    proposal: Any
    config: SubsampledMHConfig | None = None
    name: str | None = None

    @property
    def cfg(self) -> SubsampledMHConfig:
        return self.config or SubsampledMHConfig()

    @property
    def max_rounds(self) -> int:
        cfg = self.cfg
        return adaptive_max_rounds(cfg, self.target.num_sections, (cfg.batch_size,))


@dataclasses.dataclass(frozen=True)
class SweepOp:
    """An opaque inner kernel cycled between MH moves.

    ``fn(gen, theta) -> theta``, or ``-> (theta, info)`` with
    ``has_info=True`` (the info is recorded per step under this op's name).
    ``batched_fn(gen, theta) -> theta`` (optional) is the natively
    chain-batched form, every theta leaf carrying the (K,) axis; the ensemble
    calls it instead of running ``fn`` chain by chain. It must draw, for
    K = 1, what ``fn`` draws, so the sequential twin stays comparable.
    """

    fn: Callable
    name: str | None = None
    has_info: bool = False
    batched_fn: Callable | None = None


@dataclasses.dataclass(frozen=True)
class CycleOp:
    """An ordered cycle of component operators: one engine transition
    applies each component once, in order (the paper's ``(cycle (...) 1)``)."""

    ops: tuple

    def __post_init__(self):
        if not self.ops:
            raise ValueError("cycle() needs at least one component operator")
        for op in self.ops:
            if not isinstance(op, (SubsampledMHOp, SweepOp)):
                raise TypeError(f"cycle components must be SubsampledMHOp or SweepOp, got {op!r}")
        names = self.names
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate component names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(op.name if op.name is not None else f"op{i}" for i, op in enumerate(self.ops))

    @property
    def mh_ops(self) -> tuple[tuple[int, SubsampledMHOp], ...]:
        return tuple((i, op) for i, op in enumerate(self.ops) if isinstance(op, SubsampledMHOp))


def cycle(ops) -> CycleOp:
    """Build a composite cycle operator from a sequence of components.

        >>> import torch
        >>> from repro_torch.core import RandomWalk, SubsampledMHOp, SweepOp, cycle
        >>> from repro_torch.core import from_iid_loglik
        >>> t = from_iid_loglik(lambda th: -0.5 * th ** 2,
        ...                     lambda th, idx: torch.zeros(idx.shape), None, 10)
        >>> c = cycle([SubsampledMHOp(t, RandomWalk(0.1), name="theta"),
        ...            SweepOp(lambda g, th: th, name="noop")])
        >>> c.names
        ('theta', 'noop')
    """
    return CycleOp(tuple(ops))


def init_cycle_samplers(op_cycle: CycleOp, *, device=None):
    """Initial sampler state per component (an int32 zero placeholder for
    sweeps), on ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    states = []
    for op in op_cycle.ops:
        if isinstance(op, SubsampledMHOp):
            s0, _, _ = make_sampler(op.cfg.sampler, op.target.num_sections, device=dev)
            states.append(s0)
        else:
            states.append(torch.zeros((), dtype=torch.int32, device=dev))
    return tuple(states)


def run_cycle_sequential(seed, theta0: Params, op_cycle: CycleOp, num_steps: int,
                         collect: Callable[[Params], Any] | None = None, *, device=None):
    """Single-chain driver for a composite cycle: a loop over steps and, in
    each, over the components in order, all drawing from one generator.

    ``seed`` is an int or a generator on ``device`` (``None`` means the
    card). Returns ``(theta, samples, infos)``: samples stacked on a leading
    time axis, infos a dict keyed by component name (MH ops always; sweeps
    when ``has_info``).
    """
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    collect = collect or (lambda t: t)
    names = op_cycle.names
    fns = [sampler_fns(op.cfg.sampler) if isinstance(op, SubsampledMHOp) else None
           for op in op_cycle.ops]
    samplers = list(init_cycle_samplers(op_cycle, device=dev))
    theta = tree_map(lambda t: to_leaf(t, dev), theta0)
    samples, infos = [], []
    for _ in range(num_steps):
        step_infos = {}
        for i, op in enumerate(op_cycle.ops):
            if isinstance(op, SubsampledMHOp):
                reset_fn, draw_fn = fns[i]
                theta, samplers[i], step_infos[names[i]] = subsampled_mh_step(
                    gen, theta, samplers[i], op.target, op.proposal, op.cfg, reset_fn, draw_fn,
                    max_rounds=op.max_rounds)
            elif op.has_info:
                theta, step_infos[names[i]] = op.fn(gen, theta)
            else:
                theta = op.fn(gen, theta)
        samples.append(collect(theta))
        infos.append(step_infos)
    return theta, _stack(samples), _stack(infos)
