"""Configurations the port runs (counterparts of ``repro.configs``)."""
from .paper_regression import RegressionConfig
from .paper_regression import config as regression_config

__all__ = ["RegressionConfig", "regression_config"]
