"""Steps of the port's LM stack (counterpart of ``repro.train``): the
straggler-scheduled and the plain train steps, and the serve step (greedy
or sampled)."""
from .steps import (SAMPLE_STREAM, TrainState, gumbel_scores,
                    init_train_state, lm_loss, lm_loss_per_seq,
                    make_serve_step, make_straggler_train_step,
                    make_train_step)

__all__ = ["TrainState", "init_train_state", "lm_loss", "lm_loss_per_seq",
           "make_train_step", "make_straggler_train_step", "make_serve_step",
           "gumbel_scores", "SAMPLE_STREAM"]
