from .registry import ARCH_IDS, get_config, get_smoke_config, model_100m

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "model_100m"]
