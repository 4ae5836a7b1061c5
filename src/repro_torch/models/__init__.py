from .common import ModelConfig
from .model import Model

__all__ = ["ModelConfig", "Model"]
