"""The data layer: ILSVRC VID/DET index and annotations, the test and train
transforms (the SSD augmentation among them), train samples and their
aspect-ratio batches, streaming-video chunking and threaded prefetch."""

from .catalog import DATASETS, get_dataset
from .prefetch import PrefetchIterator, prefetch_map
from .samplers import aspect_ratio_group_ids, grouped_batches
from .sampling import (ConcatDataset, MethodSampleSpec, SampleConfig, VideoChunks,
                       build_train_sample, build_train_sample_method, iter_test_videos,
                       train_sample_stream)
from .transforms import (bucket_shape, frame_bucket, pad_to, resize_bilinear, resize_image,
                         resize_scale, ssd_augment, transform_frame, transform_frame_to)
from .vid_dataset import (VID_CLASSES, VID_WNIDS, WNID_TO_LABEL, FrameAnno, VIDDataset,
                          pad_groundtruth, parse_vid_xml)

__all__ = [
    "DATASETS", "get_dataset", "PrefetchIterator", "prefetch_map", "aspect_ratio_group_ids",
    "grouped_batches", "ConcatDataset", "MethodSampleSpec", "SampleConfig", "VideoChunks",
    "build_train_sample", "build_train_sample_method", "iter_test_videos",
    "train_sample_stream", "bucket_shape", "frame_bucket", "pad_to", "resize_bilinear",
    "resize_image", "resize_scale", "ssd_augment", "transform_frame", "transform_frame_to",
    "VID_CLASSES", "VID_WNIDS", "WNID_TO_LABEL", "FrameAnno", "VIDDataset",
    "pad_groundtruth", "parse_vid_xml",
]
