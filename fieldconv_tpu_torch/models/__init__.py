from .classification import ClassificationNet

__all__ = ["ClassificationNet"]
