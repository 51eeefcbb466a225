"""Data for the port: the paper's regression scenario (Sec. VI)."""
from .pipeline import regression_dataset, regression_tasks

__all__ = ["regression_dataset", "regression_tasks"]
