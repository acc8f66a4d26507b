"""Kernel K7's launch plan (``ops/window_attention.py: window_plan``) and
the wrapper's launch of it.

The plan is checked against the shared memory that
``csrc/window_attn_qkv.cu`` lays out for K7 (``WinSmem``) and the card's
limits, and by walking its blocks as the kernel does: block i takes head
group i % (heads / group) and window run i // (heads / group), which must
cover every (window, head) once.  The kernel itself runs only on the card
(``chip_smoke.py``); here a stand-in library records what the wrapper
hands to the entry point.
"""

import numpy as np
import pytest
import torch

from diffusionvid_torch.ops import _build
from diffusionvid_torch.ops import window_attention as wa

WIN, N = 7, 49
SMS = 132
# (C, B, Hp, Wp): the four Swin-B stage maps of a 4-frame chunk at 608x1024
# (the v1 stream's), then Swin-T's widths over 2 frames at 64x96, then the
# Swin-B maps of a 5-frame sample
SWIN_B_4 = [(128, 4, 154, 259), (256, 4, 77, 133), (512, 4, 42, 70), (1024, 4, 21, 35)]
PLAN_CASES = SWIN_B_4 + [(96, 2, 21, 28), (192, 2, 14, 14), (384, 2, 7, 7), (768, 2, 7, 7),
                         (128, 5, 154, 259), (512, 5, 42, 70)]


@pytest.mark.parametrize("c,b,hp,wp", PLAN_CASES)
def test_window_plan_fits_the_card(c, b, hp, wp):
    """The plan's shared memory (ring slots of three 3,584-byte tiles, the
    group's biases, the barriers) fits a block and as many blocks an SM as
    planned; its head group divides the heads; its blocks cover every
    head-window exactly once; its cost is the least of ``window_plans``;
    and Swin-B's stages 2 and 3 run more blocks than windows."""
    plan = wa.window_plan(c, b, hp, wp, sms=SMS)
    heads, windows = c // 32, b * (hp // WIN) * (wp // WIN)
    group, wpb, stages = plan["group"], plan["wpb"], plan["stages"]
    assert heads % group == 0 and 1 <= wpb <= windows and 3 <= stages <= 8
    assert plan["smem_bytes"] == stages * 3 * 3584 + group * 9616 + 256 <= 232_448
    assert plan["blocks_per_sm"] in (1, 2)
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 233_472
    groups = heads // group
    assert plan["blocks"] == groups * -(-windows // wpb)
    cover = np.zeros((windows, heads), np.int64)
    for i in range(plan["blocks"]):
        g, run = i % groups, i // groups
        cover[run * wpb:(run + 1) * wpb, g * group:(g + 1) * group] += 1
    assert (cover == 1).all()
    assert plan["work"] == group * wpb
    assert plan["waves"] == -(-plan["blocks"] // (SMS * plan["blocks_per_sm"]))
    assert plan["cost"] == min(p["cost"] for p in wa.window_plans(c, b, hp, wp, sms=SMS))
    if (c, b, hp, wp) in SWIN_B_4[2:]:
        assert plan["blocks"] > windows


def test_window_plans_list_every_group():
    """``window_plans`` offers every head group that fits shared memory,
    for head counts that are not powers of two too (Swin-T's 3, 6, 12 and
    24), and each of its plans fits the card."""
    for c in (96, 192, 384, 768, 128, 1024):
        heads = c // 32
        plans = wa.window_plans(c, 2, 21, 28, sms=SMS)
        fits = {g for g in range(1, heads + 1)
                if heads % g == 0 and 3 * 3 * 3584 + g * 9616 + 256 <= 232_448}
        assert {p["group"] for p in plans} == fits
        for p in plans:
            assert p["smem_bytes"] == wa.window_smem(p["group"], p["stages"])
            assert p["blocks_per_sm"] * (p["smem_bytes"] + 1024) <= 233_472


class _FakeLib:
    """Stands in for K6/K7's library: records the integer arguments of each
    call of K7's entry point."""

    def __init__(self):
        self.calls = []

        def window_attn_fwd(*args):
            self.calls.append([a for a in args if isinstance(a, int)])
            return 0
        self.window_attn_fwd = window_attn_fwd


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("c,b,hp,wp", [(512, 4, 42, 70), (96, 2, 21, 28)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_window_wrapper_takes_the_planned_path(monkeypatch, c, b, hp, wp, dtype):
    """Off the CPU, bf16 reaches K7's entry point with window_plan's head
    group, windows a block, ring and shared bytes for this card's SMs;
    fp32 with no plan (the first design).  Each call counts one launch."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(wa, "_sm_count", lambda index: SMS)
    heads = c // 32
    q, k, v = (_meta(b, hp, wp, c, dtype=dtype) for _ in range(3))
    mask = _meta(hp // WIN, wp // WIN, N, N)
    before = wa.window_attention.launches
    out = wa.window_attention(q, k, v, _meta(heads, N, N), mask, WIN)
    assert out.shape == q.shape and out.dtype == dtype
    assert wa.window_attention.launches == before + 1
    [ints] = lib.calls
    # ..., B, Hp, Wp, C, heads, dtype, group, wpb, stages, smem_bytes, the stream
    if dtype == torch.bfloat16:
        plan = wa.window_plan(c, b, hp, wp, SMS)
        assert ints[-11:-1] == [b, hp, wp, c, heads, 1, plan["group"], plan["wpb"],
                                plan["stages"], plan["smem_bytes"]]
    else:
        assert ints[-11:-1] == [b, hp, wp, c, heads, 0, 0, 0, 0, 0]
