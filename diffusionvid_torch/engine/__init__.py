from .postprocess import postprocess_frame, select_topk_detections
from .streaming import StreamingDetector, StreamState

__all__ = ["postprocess_frame", "select_topk_detections", "StreamingDetector",
           "StreamState"]
