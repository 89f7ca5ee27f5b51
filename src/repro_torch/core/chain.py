"""Single-chain drivers: a Python loop of transitions, and a timed loop.

The port of ``repro.core.chain``. The reference's ``lax.scan`` becomes a
loop; samples and infos are stacked on a leading time axis at the end. For
K chains at once use :class:`repro_torch.core.ensemble.ChainEnsemble`: an
ensemble of one chain reproduces :func:`run_chain` with the same seed.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from .._device import make_generator, resolve_device, tree_leaves, tree_map
from .mh import mh_step
from .subsampled_mh import SubsampledMHConfig, make_kernel
from .target import PartitionedTarget

Params = Any


def _stack(items: list) -> Any:
    """Stack per-step results (tensors, trees or info tuples) on a new
    leading axis."""
    first = items[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(col)) for col in zip(*items)))
    return tree_map(lambda *ls: torch.stack(ls), *items)


def _steps(seed, theta0, target, proposal, kernel, config, chunk_size, device):
    """Shared set-up: the device, the generator, theta on the device, and a
    ``step(theta, state) -> (theta, state, info)`` closure."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    theta = tree_map(lambda t: torch.as_tensor(t, dtype=torch.float32).to(device), theta0)
    config = config or SubsampledMHConfig()
    if kernel == "subsampled":
        state0, kstep = make_kernel(target, proposal, config, device=device)
        return theta, state0, lambda th, st: kstep(gen, th, st)
    if kernel == "exact":
        def exact(th, st):
            th, info = mh_step(gen, th, target, proposal, chunk_size=chunk_size)
            return th, st, info
        return theta, None, exact
    raise ValueError(f"unknown kernel {kernel!r}")


def run_chain(seed, theta0: Params, target: PartitionedTarget, proposal, num_steps: int,
              kernel: str = "subsampled", config: SubsampledMHConfig | None = None,
              collect: Callable[[Params], Any] | None = None,
              chunk_size: int | None = None, *, device=None):
    """Run ``num_steps`` transitions. ``seed`` is an int or a generator on
    ``device`` (``None`` means the card). Returns (theta_final,
    collected_samples, infos) with a leading time axis."""
    collect = collect or (lambda t: t)
    theta, state, step = _steps(seed, theta0, target, proposal, kernel, config,
                                chunk_size, device)
    samples, infos = [], []
    for _ in range(num_steps):
        theta, state, info = step(theta, state)
        samples.append(collect(theta))
        infos.append(info)
    return theta, _stack(samples), _stack(infos)


def run_chain_timed(seed, theta0: Params, target: PartitionedTarget, proposal,
                    num_steps: int, kernel: str = "subsampled",
                    config: SubsampledMHConfig | None = None,
                    collect: Callable[[Params], Any] | None = None,
                    callback: Callable[[int, float, Any, Any], None] | None = None,
                    chunk_size: int | None = None, *, device=None):
    """Host loop recording the wall clock after each transition (the device
    is synchronised first). The first transition is the warm-up and sets
    t = 0. Returns dict with ``samples`` (list), ``infos`` (list of dicts of
    numpy values) and ``times`` (cumulative seconds)."""
    collect = collect or (lambda t: t)
    theta, state, step = _steps(seed, theta0, target, proposal, kernel, config,
                                chunk_size, device)
    sync = torch.cuda.synchronize if tree_leaves(theta)[0].is_cuda else (lambda: None)
    samples, infos, times = [], [], []
    t_start = None
    for i in range(num_steps):
        theta, state, info = step(theta, state)
        sync()
        if t_start is None:
            t_start = time.perf_counter()
            times.append(0.0)
        else:
            times.append(time.perf_counter() - t_start)
        samples.append(tree_map(lambda t: t.cpu().numpy(), collect(theta)))
        infos.append({k: v.cpu().numpy() for k, v in info._asdict().items()})
        if callback is not None:
            callback(i, times[-1], samples[-1], infos[-1])
    return {"samples": samples, "infos": infos, "times": np.asarray(times)}


def acceptance_rate(infos) -> float:
    acc = infos.accepted if hasattr(infos, "accepted") else [i["accepted"] for i in infos]
    if isinstance(acc, torch.Tensor):
        acc = acc.cpu().numpy()
    return float(np.mean(np.asarray(acc)))
