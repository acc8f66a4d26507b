"""FlowNetS and flow-guided feature warping for the DFF and FGFA paths.

Port of ``diffusionvid_tpu/models/flownet.py`` (the reference's
``mega_core/modeling/backbone/flownet.py:14-121`` and ``embednet.py``):
the FlowNetS encoder-decoder with multi-scale flow refinement, LeakyReLU
0.1, input and output 2x2 average pools in ceil mode, the flow scaled by
2.5 and DFF's per-channel scale map; the bilinear warp with zeros outside
the map; FGFA's embedding network.  NCHW.  Parameters keep the JAX
package's names (``flow_conv1``, ``upsample_flow6to5``, ``Convolution5_scale``
...) and layouts, so its tree carries over by renaming only.

The JAX package's ``Deconv`` runs ``lax.conv_transpose`` on the stored
``[in, out, 4, 4]`` weight taken to HWIO, without ``transpose_kernel``:
it correlates the stride-dilated input with the kernel as stored, which is
``F.conv_transpose2d`` on the kernel flipped in both spatial axes.  The
port keeps the stored layout and flips at use, so the same tree gives the
same flow (ROADMAP.md §C, the deviations the port mirrors).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv2d


class Deconv(nn.Module):
    """4x4 stride-2 transposed convolution with bias, VALID (output
    ``2 * in + 2``), weight ``[in, out, 4, 4]`` as the JAX package stores
    it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator):
        """The JAX package's variance_scaling(1, fan_in) over this shape,
        whose fan-in flax counts as 4 x in x out (normal, not truncated)."""
        std = math.sqrt(1.0 / (4 * self.weight.shape[0] * self.weight.shape[1]))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=gen)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype).flip(-1, -2),
                                  self.bias.to(x.dtype), stride=2)


def _crop_like(x, ref):
    """The reference's crop (flownet.py:7-11): the deconvolution's 1-pixel
    border off, down to ``ref``'s extent."""
    if x.shape[2:] == ref.shape[2:]:
        return x
    return x[:, :, 1:ref.shape[2] + 1, 1:ref.shape[3] + 1]


def _avgpool2(x):
    """2x2 stride-2 average pool in ceil mode: an odd extent is padded by
    its edge row or column first."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, 2, 2)


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


# (name, out channels, kernel, stride, padding) of the encoder
_ENCODER = (("flow_conv1", 64, 7, 2, 3), ("conv2", 128, 5, 2, 2), ("conv3", 256, 5, 2, 2),
            ("conv3_1", 256, 3, 1, 1), ("conv4", 512, 3, 2, 1), ("conv4_1", 512, 3, 1, 1),
            ("conv5", 512, 3, 2, 1), ("conv5_1", 512, 3, 1, 1), ("conv6", 1024, 3, 2, 1),
            ("conv6_1", 1024, 3, 1, 1))


class FlowNetS(nn.Module):
    """Flow between two images: ``pair`` ``[B, 6, H, W]`` (current, then
    reference, each scaled to 0..1) → the flow ``[B, 2, ~H/16, ~W/16]``
    (dx, dy) in feature pixels x 2.5, and with ``predict_scale`` DFF's
    scale map ``[B, 1024, ...]`` + 1."""

    def __init__(self, predict_scale: bool = False, compute_dtype=torch.float32):
        super().__init__()
        self.predict_scale = predict_scale
        self.compute_dtype = compute_dtype
        cin = 6
        for name, cout, k, s, p in _ENCODER:
            self.add_module(name, Conv2d(cin, cout, k, s, p, bias=True))
            cin = cout
        # decoder: cat widths 512 + 512 + 2, 512 + 256 + 2, 256 + 128 + 2, 128 + 64 + 2
        self.Convolution1 = Conv2d(1024, 2, 3, 1, 1, bias=True)
        self.upsample_flow6to5 = Deconv(2, 2)
        self.deconv5 = Deconv(1024, 512)
        self.Convolution2 = Conv2d(1026, 2, 3, 1, 1, bias=True)
        self.upsample_flow5to4 = Deconv(2, 2)
        self.deconv4 = Deconv(1026, 256)
        self.Convolution3 = Conv2d(770, 2, 3, 1, 1, bias=True)
        self.upsample_flow4to3 = Deconv(2, 2)
        self.deconv3 = Deconv(770, 128)
        self.Convolution4 = Conv2d(386, 2, 3, 1, 1, bias=True)
        self.upsample_flow3to2 = Deconv(2, 2)
        self.deconv2 = Deconv(386, 64)
        self.Convolution5 = Conv2d(194, 2, 3, 1, 1, bias=True)
        if predict_scale:
            self.Convolution5_scale = Conv2d(194, 1024, 1, 1, 0)

    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, Deconv):
                m.reset_parameters(gen)

    def _refine(self, i, skip, flow, feat):
        up = _crop_like(getattr(self, f"upsample_flow{7 - i}to{6 - i}")(flow), skip)
        d = _lrelu(_crop_like(getattr(self, f"deconv{6 - i}")(feat), skip))
        return torch.cat([skip, d, up], 1)

    def forward(self, pair):
        x = _avgpool2(pair.to(self.compute_dtype))
        c = {}
        for name, *_ in _ENCODER:
            src = c["conv5"] if name == "conv6" else x   # conv6 reads conv5, not conv5_1
            x = c[name] = _lrelu(getattr(self, name)(src))
        feat = c["conv6_1"]
        flow = self.Convolution1(feat)
        for i, skip in enumerate((c["conv5_1"], c["conv4_1"], c["conv3_1"], c["conv2"]), 1):
            feat = self._refine(i, skip, flow, feat)
            if i < 4:
                flow = getattr(self, f"Convolution{i + 1}")(feat)
        feat = _avgpool2(feat)
        flow = self.Convolution5(feat) * 2.5
        if self.predict_scale:
            return flow, self.Convolution5_scale(feat) + 1.0
        return flow


def grid_sample_bilinear(feat, coords_y, coords_x):
    """Bilinear sampling of ``feat`` ``[B, C, H, W]`` at pixel coordinates
    ``[B, h, w]``, each of the four corners zero outside the map.  Computed
    in float32 (the JAX package promotes the bfloat16 map against its
    float32 weights) and returned in ``feat``'s dtype."""
    b, c, h, w = feat.shape
    flat = feat.float().reshape(b, c, h * w)
    y0, x0 = torch.floor(coords_y), torch.floor(coords_x)
    ly, lx = coords_y - y0, coords_x - x0

    def gather(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()).reshape(b, 1, -1)
        g = torch.gather(flat, 2, idx.expand(b, c, idx.shape[2])).reshape(b, c, *yy.shape[1:])
        return g * ok[:, None].float()

    out = (gather(y0, x0) * ((1 - ly) * (1 - lx))[:, None]
           + gather(y0, x0 + 1) * ((1 - ly) * lx)[:, None]
           + gather(y0 + 1, x0) * (ly * (1 - lx))[:, None]
           + gather(y0 + 1, x0 + 1) * (ly * lx)[:, None])
    return out.to(feat.dtype)


def warp_features(feat, flow):
    """``feat`` ``[B, C, H, W]`` warped by ``flow`` ``[B, 2, H, W]``, (dx,
    dy) in feature pixels: the output at (y, x) samples (y + dy, x + dx)."""
    _, _, h, w = flow.shape
    flow = flow.float()
    yy = torch.arange(h, dtype=torch.float32, device=flow.device)[None, :, None] + flow[:, 1]
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :] + flow[:, 0]
    return grid_sample_bilinear(feat, yy, xx)


class EmbedNet(nn.Module):
    """FGFA's embedding for the cosine weights (embednet.py:8-27):
    1x1 512, ReLU, 3x3 512, ReLU, 1x1 2048."""

    def __init__(self):
        super().__init__()
        self.embed_conv1 = Conv2d(1024, 512, 1, bias=True)
        self.embed_conv2 = Conv2d(512, 512, 3, 1, 1, bias=True)
        self.embed_conv3 = Conv2d(512, 2048, 1, bias=True)

    def forward(self, x):
        x = F.relu(self.embed_conv1(x))
        x = F.relu(self.embed_conv2(x))
        return self.embed_conv3(x)
