from .common import ModelConfig
from .model import WORKLOADS, Model, Workload

__all__ = ["ModelConfig", "Model", "WORKLOADS", "Workload"]
