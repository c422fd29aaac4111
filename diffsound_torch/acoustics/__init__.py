from .bem import BEMModel

__all__ = ["BEMModel"]
