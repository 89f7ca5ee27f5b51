"""A miniature inference programming language (the paper's ``[infer ...]``):
the port of ``repro.inference.kernels``.

Inference programs are composable transition kernels over a shared state,
callables ``(gen, state) -> state`` that draw what they need from the
``torch.Generator`` they are handed, in order. The paper's

    [infer (cycle ((mh alpha all 1)
                   (gibbs z one step_z)
                   (subsampled_mh w one {Nbatch} {eps} 'drift {sigma} 1)) 1)]

is ``Cycle([alpha_kernel, z_kernel, w_kernel])``. Where the reference splits
a key per kernel, the port hands every kernel the same generator, one draw
after another.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from .._device import make_generator, resolve_device

State = Any
Kernel = Callable[[torch.Generator, State], State]


@dataclasses.dataclass
class Cycle:
    """Apply each kernel once, in order, ``repeats`` times per call."""

    kernels: Sequence[Kernel]
    repeats: int = 1

    def __call__(self, gen: torch.Generator, state: State) -> State:
        for _ in range(self.repeats):
            for k in self.kernels:
                state = k(gen, state)
        return state


@dataclasses.dataclass
class Repeat:
    kernel: Kernel
    times: int

    def __call__(self, gen: torch.Generator, state: State) -> State:
        for _ in range(self.times):
            state = self.kernel(gen, state)
        return state


@dataclasses.dataclass
class Mixture:
    """Randomly pick one kernel per call (optionally weighted)."""

    kernels: Sequence[Kernel]
    weights: Sequence[float] | None = None

    def __call__(self, gen: torch.Generator, state: State) -> State:
        n = len(self.kernels)
        w = torch.ones(n, dtype=torch.float64) if self.weights is None else \
            torch.as_tensor(self.weights, dtype=torch.float64)
        u = torch.rand((), generator=gen, dtype=torch.float64, device=gen.device)
        cdf = torch.cumsum(w / w.sum(), 0)
        i = min(int((cdf <= float(u)).sum()), n - 1)
        return self.kernels[i](gen, state)


def run_inference(seed, state: State, program: Kernel, num_iterations: int,
                  callback: Callable[[int, State], None] | None = None, *,
                  device=None) -> State:
    """Drive an inference program; the paper's outer ``[infer ... 1]`` loop.
    ``seed`` is an int (a generator on ``device``, ``None`` meaning the
    card) or a generator, whose own device is used."""
    dev = seed.device if isinstance(seed, torch.Generator) else resolve_device(device)
    gen = make_generator(seed, dev)
    for it in range(num_iterations):
        state = program(gen, state)
        if callback is not None:
            callback(it, state)
    return state
