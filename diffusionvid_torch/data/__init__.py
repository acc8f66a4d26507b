"""The inference data layer: ILSVRC VID index and annotations, the test
transforms, streaming-video chunking and threaded prefetch."""

from .catalog import DATASETS, get_dataset
from .prefetch import PrefetchIterator, prefetch_map
from .sampling import SampleConfig, VideoChunks, iter_test_videos
from .transforms import bucket_shape, frame_bucket, pad_to, resize_image, resize_scale, transform_frame
from .vid_dataset import VID_CLASSES, VID_WNIDS, WNID_TO_LABEL, FrameAnno, VIDDataset, parse_vid_xml

__all__ = [
    "DATASETS", "get_dataset", "PrefetchIterator", "prefetch_map", "SampleConfig",
    "VideoChunks", "iter_test_videos", "bucket_shape", "frame_bucket", "pad_to",
    "resize_image", "resize_scale", "transform_frame", "VID_CLASSES", "VID_WNIDS",
    "WNID_TO_LABEL", "FrameAnno", "VIDDataset", "parse_vid_xml",
]
