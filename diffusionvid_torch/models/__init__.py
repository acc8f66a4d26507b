from .diffusion_det import (
    DiffusionDetArch, boxes_to_signal, ddim_times, make_schedule, signal_to_boxes,
)
from .heads import DynamicHead, RCNNHead
from .resnet import ResNet
from .swin import SwinTransformer

__all__ = ["DiffusionDetArch", "DynamicHead", "RCNNHead", "ResNet", "SwinTransformer",
           "boxes_to_signal", "ddim_times", "make_schedule", "signal_to_boxes"]
