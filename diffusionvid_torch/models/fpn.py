"""Feature Pyramid Network over a ResNet or Swin trunk (detectron2 layout).

Port of ``diffusionvid_tpu/models/fpn.py``: lateral 1x1 + nearest-2x
top-down sum + 3x3 output, p3–p5 from res3–res5 or swin1–swin3.  Like
detectron2's FPN module it owns the trunk as ``bottom_up``, so its tensors
are named ``backbone.bottom_up.*`` and ``backbone.fpn_{lateral,output}{level}.*``.
The LastLevelMaxPool p6 is not built: the head reads p3–p5 only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import RESNET_FEATURE_STRIDES, Conv2d
from .swin import SWIN_FEATURE_STRIDES

FEATURE_STRIDES = {**RESNET_FEATURE_STRIDES, **SWIN_FEATURE_STRIDES}


class FPN(nn.Module):
    def __init__(self, bottom_up: nn.Module, in_features=("res3", "res4", "res5"),
                 in_channels=(512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.levels = [int(math.log2(FEATURE_STRIDES[k])) for k in self.in_features]
        for lvl, cin in zip(self.levels, in_channels):
            self.add_module(f"fpn_lateral{lvl}", Conv2d(cin, out_channels, 1, bias=True))
            self.add_module(f"fpn_output{lvl}",
                            Conv2d(out_channels, out_channels, 3, padding=1, bias=True))

    def reset_parameters(self, gen: torch.Generator):
        self.bottom_up.reset_parameters(gen)
        for lvl in self.levels:
            for kind in ("lateral", "output"):
                conv = getattr(self, f"fpn_{kind}{lvl}")
                fan_out = conv.weight.shape[0] * conv.weight.shape[2] * conv.weight.shape[3]
                with torch.no_grad():
                    conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
                    conv.bias.zero_()

    def forward(self, feats: dict) -> dict:
        """The trunk's NCHW maps by name → {"p<level>": NCHW map}."""
        xs = [feats[k] for k in self.in_features]
        outs = [None] * len(xs)
        prev = getattr(self, f"fpn_lateral{self.levels[-1]}")(xs[-1])
        outs[-1] = getattr(self, f"fpn_output{self.levels[-1]}")(prev)
        for i in range(len(xs) - 2, -1, -1):
            lateral = getattr(self, f"fpn_lateral{self.levels[i]}")(xs[i])
            up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
            prev = lateral + up[:, :, : lateral.shape[2], : lateral.shape[3]]
            outs[i] = getattr(self, f"fpn_output{self.levels[i]}")(prev)
        return {f"p{lvl}": o for lvl, o in zip(self.levels, outs)}
