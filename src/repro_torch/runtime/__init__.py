"""Fault-tolerant chain loop (the port of ``repro.runtime``)."""
from .train_loop import InjectedFailure, LoopConfig, PreemptionRequested, run_loop, step_generator

__all__ = ["InjectedFailure", "LoopConfig", "PreemptionRequested", "run_loop", "step_generator"]
