"""Fault-tolerant chain loop (the port of ``repro.runtime``)."""
from .train_loop import (
    InjectedFailure,
    LoopConfig,
    PreemptionRequested,
    run_loop,
    step_generator,
    wall_clock_step_stats,
)

__all__ = ["InjectedFailure", "LoopConfig", "PreemptionRequested", "run_loop", "step_generator",
           "wall_clock_step_stats"]
