"""The port's core: delay models, round-aware processes and the fault
scenarios, trace replay and calibration, TO matrices, the adaptive
scheduler and load re-balancing, completion times, the single-round and
rounds Monte-Carlo engines (round deadlines, trace recording, resumable
sweeps, the evaluator cache), the grid engine and the racing planner,
Theorem 1 and the lower bound, coded baselines and the aggregator
(counterparts of ``repro.core``), and lazy re-exports of the live layer
(``repro_torch.live``)."""
from .aggregator import StragglerAggregator
from .cluster import (FAULT_SCENARIOS, AR1Process, DelayProcess,
                      DiurnalLoadProcess, FaultProcess, IIDProcess,
                      MarkovRegimeProcess, MessageLossProcess,
                      NetworkPartitionProcess, RackFailureProcess,
                      SpotPreemptionProcess, as_process, ec2_cluster,
                      heterogeneous_scales, make_scenario,
                      message_comm_delays)
from .coded import (pc_decode, pc_encode, pc_threshold, pc_worker_compute,
                    pcmm_decode, pcmm_encode, pcmm_threshold,
                    pcmm_worker_compute, simulate_pc_completion,
                    simulate_pcmm_completion)
from .completion import (apply_row_layout, completion_time,
                         first_k_distinct_mask, lower_bound_time,
                         mean_completion_time, message_arrival_times,
                         message_slot_layout, row_layout_is_identity,
                         simulate_completion, simulate_lower_bound,
                         slot_arrival_times, task_arrival_times,
                         winner_mask_gather)
from .delays import (BimodalStragglerDelays, DelayModel, EmpiricalDelays,
                     ShiftedExponentialDelays, TruncatedGaussianDelays,
                     ec2_like, scenario1, scenario2)
from .grid import (GRID_FORMAT_VERSION, GridCell, GridResult, GridSpec,
                   stream_grid)
from .montecarlo import (ResumableSweep, RoundsResult, SchemeSpec,
                         SweepResult, adaptive_spec, cache_stats, clear_cache,
                         completion_samples, lb_spec, message_boundaries,
                         message_group_sizes, message_slot_map, pc_spec,
                         pcmm_spec, resumable_sweep, set_cache_capacity,
                         sweep, sweep_rounds, task_arrival_samples,
                         task_arrival_times_gather, task_gather_plan,
                         tau_spec, to_spec, trajectory_samples)
from .planner import PLAN_FORMAT_VERSION, PlanResult, plan
from .scheduling import (GREEDY_IMPLS, MASKED, SCHEDULES, AdaptiveScheduler,
                         Schedule, block_to_matrix, censored_feedback_update,
                         cyclic_to_matrix, greedy_load_rebalance,
                         greedy_load_rebalance_batch, greedy_row_assignment,
                         greedy_row_assignment_batch, loads_of_matrix,
                         mask_matrix_loads, random_assignment_to_matrix,
                         staircase_to_matrix, to_matrix, validate_to_matrix)
from .spec import DEADLINE_POLICIES, RoundConfig, validate_deadline
from .theory import (delay_model_pdfs, joint_survival_mc,
                     lower_bound_mean_mc, lower_bound_tail_mc,
                     multimessage_coded_mean, multimessage_coded_tail,
                     multimessage_marginal_cdfs, operating_point_mean_lb,
                     sum_survival_grid, theorem1_mean_mc,
                     theorem1_tail_from_H, theorem1_tail_mc,
                     theorem1_tail_r1_independent, truncated_gaussian_pdf)
from .trace import (TRACE_FORMAT_VERSION, CalibrationReport, DelayTrace,
                    TraceProcess, calibrate_trace, load_trace, save_trace,
                    validate_trace_file)

__all__ = [
    "StragglerAggregator", "DelayProcess", "IIDProcess", "as_process",
    "MarkovRegimeProcess", "AR1Process", "ec2_cluster",
    "heterogeneous_scales", "message_comm_delays", "FaultProcess",
    "SpotPreemptionProcess", "NetworkPartitionProcess", "RackFailureProcess",
    "MessageLossProcess", "DiurnalLoadProcess", "FAULT_SCENARIOS",
    "make_scenario", "CalibrationReport", "calibrate_trace",
    "greedy_load_rebalance", "greedy_load_rebalance_batch",
    "TRACE_FORMAT_VERSION", "DelayTrace",
    "TraceProcess", "load_trace", "save_trace", "validate_trace_file",
    "RoundsResult", "adaptive_spec", "sweep_rounds", "trajectory_samples",
    "GREEDY_IMPLS", "AdaptiveScheduler", "censored_feedback_update",
    "greedy_row_assignment", "greedy_row_assignment_batch",
    "pc_decode", "pc_encode", "pc_threshold", "pc_worker_compute",
    "pcmm_decode", "pcmm_encode", "pcmm_threshold", "pcmm_worker_compute",
    "simulate_pc_completion", "simulate_pcmm_completion",
    "apply_row_layout", "completion_time", "first_k_distinct_mask",
    "lower_bound_time", "message_arrival_times", "message_slot_layout",
    "row_layout_is_identity", "slot_arrival_times", "task_arrival_times",
    "winner_mask_gather", "BimodalStragglerDelays", "DelayModel",
    "EmpiricalDelays", "ShiftedExponentialDelays", "TruncatedGaussianDelays",
    "ec2_like", "scenario1", "scenario2", "SchemeSpec", "SweepResult",
    "completion_samples", "lb_spec", "message_boundaries",
    "message_group_sizes", "message_slot_map", "pc_spec", "pcmm_spec",
    "sweep", "task_arrival_samples", "task_arrival_times_gather",
    "task_gather_plan", "tau_spec", "to_spec", "MASKED", "SCHEDULES",
    "Schedule", "block_to_matrix", "cyclic_to_matrix", "loads_of_matrix",
    "mask_matrix_loads", "random_assignment_to_matrix",
    "staircase_to_matrix", "to_matrix", "validate_to_matrix",
    "DEADLINE_POLICIES", "RoundConfig", "validate_deadline",
    "mean_completion_time", "simulate_completion", "simulate_lower_bound",
    "theorem1_tail_from_H", "joint_survival_mc", "theorem1_tail_mc",
    "theorem1_mean_mc", "lower_bound_tail_mc", "lower_bound_mean_mc",
    "sum_survival_grid", "theorem1_tail_r1_independent",
    "multimessage_marginal_cdfs", "multimessage_coded_tail",
    "multimessage_coded_mean", "truncated_gaussian_pdf", "delay_model_pdfs",
    "operating_point_mean_lb", "clear_cache", "cache_stats",
    "set_cache_capacity", "ResumableSweep", "resumable_sweep", "GridCell",
    "GridSpec", "GridResult", "stream_grid", "GRID_FORMAT_VERSION", "plan",
    "PlanResult", "PLAN_FORMAT_VERSION",
]

# ------------------- live-layer facade (lazy re-exports) ---------------------
# repro_torch.live imports from repro_torch.core's submodules, so importing
# it eagerly here would be circular; PEP 562 resolves the names on first
# access (the JAX package's facade, the same names).
_LIVE_EXPORTS = ("run_live", "Master", "LiveResult", "RoundReport",
                 "run_worker", "sample_delay_tables", "Comm", "Listener",
                 "CommClosedError", "connect", "listen")


def __getattr__(name):
    if name in _LIVE_EXPORTS:
        from .. import live
        return getattr(live, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LIVE_EXPORTS))
