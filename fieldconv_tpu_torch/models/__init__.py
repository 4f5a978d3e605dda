from .classification import ClassificationNet
from .correspondence import CorrespondenceNet
from .segmentation import SegmentationNet

__all__ = ["ClassificationNet", "CorrespondenceNet", "SegmentationNet"]
