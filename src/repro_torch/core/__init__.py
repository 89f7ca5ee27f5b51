"""Core algorithms (paper Alg. 1-3) in PyTorch: the port of ``repro.core``.

Covered so far: samplers, Welford and the Student-t test, the sequential
test, the subsampled and exact MH transitions, the single-chain drivers, the
``logit`` and ``gaussian_ar1`` target families, composite cycles and the
lock-step ensemble (single kernels and cycles).
"""
from .chain import acceptance_rate, run_chain, run_chain_timed
from .composite import (
    CycleOp,
    SubsampledMHOp,
    SweepOp,
    cycle,
    init_cycle_samplers,
    run_cycle_sequential,
)
from .ensemble import ChainEnsemble, EnsembleState, run_ensemble
from .mh import MHInfo, exact_decide, mh_step
from .proposals import IndependentGaussian, RandomWalk
from .samplers import (
    FisherYatesState,
    StreamSliceState,
    fy_draw,
    fy_init,
    fy_reset,
    make_sampler,
    stream_draw,
    stream_init,
    stream_reset,
)
from .sequential_test import SeqTestResult, sequential_test, test_round_decision
from .stats import (
    Welford,
    effective_sample_size,
    ensemble_summary,
    finite_population_std_err,
    multichain_ess,
    split_rhat,
    student_t_sf,
    tail_latency_summary,
    two_sided_t_pvalue,
)
from .subsampled_mh import (
    SubsampledMHConfig,
    SubsampledMHInfo,
    adaptive_max_rounds,
    finish_transition,
    make_kernel,
    propose_and_mu0,
    subsampled_mh_step,
)
from .target import PartitionedTarget, from_iid_loglik
from .target_builder import KernelFamily, build_target, get_family, register_family, registered_families

__all__ = [
    "ChainEnsemble", "CycleOp", "EnsembleState", "SubsampledMHOp", "SweepOp", "cycle",
    "init_cycle_samplers", "run_cycle_sequential", "FisherYatesState", "IndependentGaussian",
    "KernelFamily", "MHInfo", "PartitionedTarget", "RandomWalk", "SeqTestResult",
    "StreamSliceState", "SubsampledMHConfig", "SubsampledMHInfo", "Welford",
    "acceptance_rate", "adaptive_max_rounds", "build_target", "effective_sample_size",
    "ensemble_summary", "exact_decide", "finish_transition", "finite_population_std_err",
    "from_iid_loglik", "fy_draw", "fy_init", "fy_reset", "get_family", "make_kernel",
    "make_sampler", "mh_step", "multichain_ess", "propose_and_mu0", "register_family",
    "registered_families", "run_chain", "run_chain_timed", "run_ensemble",
    "sequential_test", "split_rhat", "stream_draw", "stream_init", "stream_reset",
    "student_t_sf", "subsampled_mh_step", "tail_latency_summary", "test_round_decision",
    "two_sided_t_pvalue",
]
