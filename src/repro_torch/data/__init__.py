from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
