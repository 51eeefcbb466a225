"""The port's core: delay models and processes, static TO matrices,
completion times, the single-round Monte-Carlo engine, coded baselines and
the static aggregator (counterparts of ``repro.core``)."""
from .aggregator import StragglerAggregator
from .cluster import DelayProcess, IIDProcess, as_process
from .coded import (pc_decode, pc_encode, pc_threshold, pc_worker_compute,
                    pcmm_decode, pcmm_encode, pcmm_threshold,
                    pcmm_worker_compute, simulate_pc_completion,
                    simulate_pcmm_completion)
from .completion import (apply_row_layout, completion_time,
                         first_k_distinct_mask, lower_bound_time,
                         message_arrival_times, message_slot_layout,
                         row_layout_is_identity, slot_arrival_times,
                         task_arrival_times, winner_mask_gather)
from .delays import (BimodalStragglerDelays, DelayModel, EmpiricalDelays,
                     ShiftedExponentialDelays, TruncatedGaussianDelays,
                     ec2_like, scenario1, scenario2)
from .montecarlo import (SchemeSpec, SweepResult, completion_samples,
                         lb_spec, message_boundaries, message_group_sizes,
                         message_slot_map, pc_spec, pcmm_spec, sweep,
                         task_arrival_samples, task_arrival_times_gather,
                         task_gather_plan, tau_spec, to_spec)
from .scheduling import (MASKED, SCHEDULES, Schedule, block_to_matrix,
                         cyclic_to_matrix, loads_of_matrix, mask_matrix_loads,
                         random_assignment_to_matrix, staircase_to_matrix,
                         to_matrix, validate_to_matrix)
from .spec import DEADLINE_POLICIES, RoundConfig, validate_deadline

__all__ = [
    "StragglerAggregator", "DelayProcess", "IIDProcess", "as_process",
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
]
