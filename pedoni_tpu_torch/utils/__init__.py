from .geometry import distance_from_segment, widen_segment
from .timing import Timer

__all__ = ["distance_from_segment", "widen_segment", "Timer"]
