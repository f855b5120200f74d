from .config import ModelConfig, reduced
from .zoo import LM, count_params, layer_groups

__all__ = ["ModelConfig", "reduced", "LM", "count_params", "layer_groups"]
