"""The port's core: delay models and round-aware processes, trace replay,
TO matrices and the adaptive scheduler, completion times, the single-round
and rounds Monte-Carlo engines, Theorem 1 and the lower bound, coded
baselines and the aggregator (counterparts of ``repro.core``)."""
from .aggregator import StragglerAggregator
from .cluster import (AR1Process, DelayProcess, IIDProcess,
                      MarkovRegimeProcess, as_process, ec2_cluster,
                      heterogeneous_scales)
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
from .montecarlo import (RoundsResult, SchemeSpec, SweepResult,
                         adaptive_spec, completion_samples, lb_spec,
                         message_boundaries, message_group_sizes,
                         message_slot_map, pc_spec, pcmm_spec, sweep,
                         sweep_rounds, task_arrival_samples,
                         task_arrival_times_gather, task_gather_plan,
                         tau_spec, to_spec, trajectory_samples)
from .scheduling import (GREEDY_IMPLS, MASKED, SCHEDULES, AdaptiveScheduler,
                         Schedule, block_to_matrix, censored_feedback_update,
                         cyclic_to_matrix, greedy_row_assignment,
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
from .trace import (TRACE_FORMAT_VERSION, DelayTrace, TraceProcess,
                    load_trace, save_trace, validate_trace_file)

__all__ = [
    "StragglerAggregator", "DelayProcess", "IIDProcess", "as_process",
    "MarkovRegimeProcess", "AR1Process", "ec2_cluster",
    "heterogeneous_scales", "TRACE_FORMAT_VERSION", "DelayTrace",
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
    "operating_point_mean_lb",
]
