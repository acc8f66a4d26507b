"""ResNet trunk (torchvision bottlenecks, FrozenBN) in detectron2 layout.

Port of ``diffusionvid_tpu/models/resnet.py``.  Module names are
detectron2's (``stem.conv1``, ``res{2..5}.{i}.conv{1,2,3}``,
``.shortcut``, each conv with its ``.norm``), so a reference checkpoint's
``backbone.bottom_up.*`` tensors load with ``load_state_dict``.  The JAX
package's W-packed space-to-depth stem is a TPU layout trick with the same
arithmetic as the plain 7x7/s2 convolution used here.

Parameters stay float32; each layer casts its weight to the compute dtype
at use, as the JAX package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# depth -> bottleneck blocks per stage
RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
RESNET_FEATURE_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics, folded to one scale and shift
    (detectron2 FrozenBatchNorm2d, eps 1e-5).  NCHW.

    As in the JAX package, and unlike detectron2, whose four tensors are
    buffers, all four are parameters: the trainer updates ``weight`` and
    ``bias`` with the backbone and never updates ``running_mean`` and
    ``running_var``, whose gradients still count in the gradient clip
    (``engine/train.py``).  The state-dict names are detectron2's."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv2d(nn.Module):
    """Convolution with an optional bias and an optional ``norm``
    (detectron2's ``layers.Conv2d``), run in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False, norm: bool = False,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.norm = FrozenBatchNorm2d(cout) if norm else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding,
                     self.dilation, self.groups)
        return y if self.norm is None else self.norm(y)


class BasicStem(nn.Module):
    def __init__(self, cout: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, cout, 7, stride=2, padding=3, norm=True)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    """torchvision bottleneck: 1x1 → 3x3 (stride) → 1x1, FrozenBN, ReLU.
    A dilation above 1 sets the stride to 1 (maskrcnn-benchmark's
    ``Bottleneck``: "if dilation > 1: stride = 1").  ``groups`` is
    ResNeXt's cardinality, on the 3x3 only."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        if dilation > 1:
            stride = 1
        self.shortcut = (Conv2d(cin, cout, 1, stride=stride, norm=True)
                         if (stride != 1 or cin != cout) else None)
        self.conv1 = Conv2d(cin, mid, 1, norm=True)
        self.conv2 = Conv2d(mid, mid, 3, stride=stride, padding=dilation, norm=True,
                            dilation=dilation, groups=groups)
        self.conv3 = Conv2d(mid, cout, 1, norm=True)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        identity = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + identity)


def he_init_(module: nn.Module, gen: torch.Generator):
    """Every ``Conv2d`` under ``module``: normal with variance 2 / fan-out."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            fan_out = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


def bottleneck_width(num_groups: int, width_per_group: int) -> int:
    """res2's bottleneck width, doubling a stage: ResNeXt's ``NUM_GROUPS x
    WIDTH_PER_GROUP``, else 64 (the JAX package's rule, which ignores
    ``WIDTH_PER_GROUP`` without groups)."""
    return num_groups * width_per_group if num_groups > 1 else 64


class ResNet(nn.Module):
    """Stem + stages res2..res<max of out_features>; returns the requested
    stage outputs (NCHW).  ``num_groups`` above 1 makes it ResNeXt (the 3x3
    convolutions grouped, the bottlenecks ``num_groups x width_per_group``
    wide at res2); ``STRIDE_IN_1X1`` is ignored, as in the JAX package."""

    def __init__(self, depth: int = 101, out_features=("res3", "res4", "res5"),
                 num_groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = BasicStem(64)
        max_stage = max(int(k[-1]) for k in self.out_features)
        cin, mid, cout = 64, bottleneck_width(num_groups, width_per_group), 256
        self.stage_names = []
        for idx, n_blocks in enumerate(RESNET_STAGES[depth]):
            stage = idx + 2
            if stage > max_stage:
                break
            blocks = [BottleneckBlock(cin if b == 0 else cout, mid, cout,
                                      (1 if idx == 0 else 2) if b == 0 else 1,
                                      groups=num_groups)
                      for b in range(n_blocks)]
            self.add_module(f"res{stage}", nn.Sequential(*blocks))
            self.stage_names.append(f"res{stage}")
            cin, mid, cout = cout, mid * 2, cout * 2

    def reset_parameters(self, gen: torch.Generator):
        """He init over fan-out (the JAX package's variance_scaling(2.0,
        "fan_out"), normal instead of truncated), identity FrozenBN."""
        he_init_(self, gen)

    def forward(self, x):
        x = self.stem(x)
        outs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            outs[name] = x
        return {k: outs[k] for k in self.out_features}


class ResNetStage(nn.Module):
    """One standalone ResNet stage: the C4 architectures' res5 box head on
    the pooled 14x14 features (the JAX package's ``ResNetStage``; the
    reference's ``ResNetHead``).  ``dilation`` is ``RES5_DILATION``; above 1
    the stage keeps stride 1.  ``num_groups`` and ``width_per_group`` as in
    ``ResNet``."""

    def __init__(self, depth: int = 101, stage: int = 5, stride: int = 2,
                 dilation: int = 1, num_groups: int = 1, width_per_group: int = 64):
        super().__init__()
        n_blocks = RESNET_STAGES[depth][stage - 2]
        mid = bottleneck_width(num_groups, width_per_group) * 2 ** (stage - 2)
        cout = 256 * 2 ** (stage - 2)
        cin = cout // 2
        self.stage = stage
        self.add_module(f"res{stage}", nn.Sequential(*[
            BottleneckBlock(cin if b == 0 else cout, mid, cout, stride if b == 0 else 1,
                            dilation, num_groups) for b in range(n_blocks)]))

    def forward(self, x):
        return getattr(self, f"res{self.stage}")(x)
