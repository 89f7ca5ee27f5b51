"""Core algorithms (paper Alg. 1-3) in PyTorch: the port of ``repro.core``.

Covered so far: samplers (with the bounded draws), Welford and the
Student-t test, the sequential test, the subsampled and exact MH
transitions, the proposals (random walk, MALA, independence), the
single-chain drivers, the ``logit``, ``gaussian_ar1``, ``ce`` and
``gaussian_mean`` target families with their ``TargetSpec`` recipes and
streaming append, composite cycles, the adaptive scheduler, the ensemble in
lock-step (single kernels and cycles) and masked stepping, and the Sec. 3.3
safeguard's trial-run report.
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
from .proposals import MALA, IndependentGaussian, RandomWalk
from .safeguard import TrialReport, trial_run_report
from .samplers import (
    FisherYatesState,
    StreamSliceState,
    fy_draw,
    fy_draw_bounded,
    fy_from_buffer,
    fy_init,
    fy_reset,
    make_bounded_draw,
    make_sampler,
    stream_draw,
    stream_draw_bounded,
    stream_init,
    stream_reset,
)
from .schedule import (
    ControllerState,
    ScheduleConfig,
    controller_init,
    controller_params,
    controller_update,
)
from .sequential_test import (
    SeqTestResult,
    expected_batches_theoretical,
    sequential_test,
    test_round_decision,
)
from .stats import (
    Welford,
    autocorrelation,
    effective_sample_size,
    ensemble_summary,
    finite_population_std_err,
    jarque_bera,
    multichain_ess,
    predictive_risk,
    slo_summary,
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
from .target_builder import (
    KernelFamily,
    TargetSpec,
    append_observations,
    build_from_spec,
    build_target,
    get_family,
    register_family,
    registered_families,
    spec_of,
)

__all__ = [
    "ChainEnsemble", "ControllerState", "CycleOp", "EnsembleState", "SubsampledMHOp",
    "SweepOp", "cycle", "init_cycle_samplers", "run_cycle_sequential", "FisherYatesState",
    "IndependentGaussian", "KernelFamily", "TargetSpec", "append_observations", "build_from_spec", "MALA", "MHInfo", "PartitionedTarget",
    "RandomWalk", "ScheduleConfig", "SeqTestResult", "StreamSliceState",
    "SubsampledMHConfig", "SubsampledMHInfo", "TrialReport", "Welford", "acceptance_rate",
    "adaptive_max_rounds", "autocorrelation", "build_target", "controller_init",
    "controller_params", "controller_update", "effective_sample_size", "ensemble_summary", "expected_batches_theoretical",
    "exact_decide", "finish_transition", "finite_population_std_err", "from_iid_loglik",
    "fy_draw", "fy_draw_bounded", "fy_from_buffer", "fy_init", "fy_reset", "get_family",
    "jarque_bera", "make_bounded_draw",
    "make_kernel", "make_sampler", "mh_step", "multichain_ess", "predictive_risk", "propose_and_mu0",
    "register_family", "registered_families", "spec_of", "run_chain", "run_chain_timed", "run_ensemble",
    "sequential_test", "slo_summary", "split_rhat", "stream_draw", "stream_draw_bounded",
    "stream_init", "stream_reset", "student_t_sf", "subsampled_mh_step", "tail_latency_summary",
    "test_round_decision", "trial_run_report", "two_sided_t_pvalue",
]
