"""Data for the port: the LM task partitioning and micro-batching, and the
paper's regression scenario (Sec. VI)."""
from .pipeline import (TaskPartition, bigram_tokens, lm_task_batches,
                       regression_dataset, regression_tasks,
                       synthetic_tokens, task_tokens)

__all__ = ["TaskPartition", "synthetic_tokens", "bigram_tokens",
           "task_tokens", "lm_task_batches", "regression_dataset",
           "regression_tasks"]
