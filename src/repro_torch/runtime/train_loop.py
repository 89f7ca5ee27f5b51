"""Fault-tolerant chain loop: the port of ``repro.runtime.train_loop``.

Chain state is small and exact: (step, params). Each step's randomness comes
from a ``torch.Generator`` keyed by (seed, step) (:func:`step_generator`),
the counterpart of the reference's ``fold_in(key, step)``, so a resumed run
needs no generator state and repeats the original trajectory. Preemption:
SIGTERM or a flag file triggers a final checkpoint and a clean exit; any
accepted transition is a consistent state. ``fail_at_step`` injects a
failure for tests. :func:`wall_clock_step_stats` times a step function for
benchmarks. Sharded parameters (``repro_torch.distributed.ShardedTensor``
leaves) are saved piece by piece and restored onto the pieces' slots by the
restore target's own shardings; the step's generator lives on their home
device.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from .._device import tree_leaves
from ..checkpoint import manager as ckpt


@dataclasses.dataclass
class LoopConfig:
    num_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    seed: int = 0
    preempt_flag: str | None = None  # touch this file to request a clean stop
    fail_at_step: int | None = None  # fault-injection hook for tests


class PreemptionRequested(Exception):
    pass


class InjectedFailure(Exception):
    pass


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded with ``seed``."""
    s = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def run_loop(
    step_fn: Callable,  # (gen, params, batch) -> (params, info)
    params: Any,
    batch_fn: Callable[[int], Any],
    cfg: LoopConfig,
    collect: Callable[[Any, Any], Any] | None = None,
) -> dict:
    """Drive transitions with periodic checkpoints and deterministic resume.
    Returns {params, step, infos, samples}; ``infos`` holds numpy values."""
    start_step = 0
    latest = ckpt.latest_step(cfg.ckpt_dir)
    if latest is not None:
        start_step, params = ckpt.restore(cfg.ckpt_dir, latest, target=params)
        start_step = int(start_step) + 1

    stop = {"flag": False}

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        stop["flag"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)
    device = tree_leaves(params)[0].device
    infos, samples = [], []
    try:
        for step in range(start_step, cfg.num_steps):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            if stop["flag"] or (cfg.preempt_flag and os.path.exists(cfg.preempt_flag)):
                ckpt.save(cfg.ckpt_dir, step - 1, params, keep=cfg.keep)
                raise PreemptionRequested(f"preempted before step {step}")
            params, info = step_fn(step_generator(cfg.seed, step, device), params,
                                   batch_fn(step))
            infos.append({k: v.cpu().numpy() for k, v in info._asdict().items()})
            if collect is not None:
                samples.append(collect(params, info))
            if (step + 1) % cfg.ckpt_every == 0 or step == cfg.num_steps - 1:
                ckpt.save(cfg.ckpt_dir, step, params, keep=cfg.keep)
        return {"params": params, "step": cfg.num_steps - 1, "infos": infos, "samples": samples}
    finally:
        signal.signal(signal.SIGTERM, old)


def _sync_outputs(out: Any) -> None:
    """Wait for the card to finish the work behind ``out``'s CUDA tensors (a
    tensor or a tree of them); nothing for CPU outputs."""
    devices = {t.device for t in tree_leaves(out) if isinstance(t, torch.Tensor)
               and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def wall_clock_step_stats(step_fn, args, n: int = 5) -> dict:
    """Utility for benchmarks: one warm call, then ``n`` timed calls, each
    closed by ``torch.cuda.synchronize`` on its outputs' devices. Returns
    ``{"mean_s", "min_s"}``."""
    _sync_outputs(step_fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = step_fn(*args)
        _sync_outputs(out)
        times.append(time.perf_counter() - t0)
        del out
    return {"mean_s": float(np.mean(times)), "min_s": float(np.min(times))}
