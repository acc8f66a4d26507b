"""MEGA's pixel paths (``LOCAL/GLOBAL.PIXEL_ATTEND``) in the port against the
JAX package.

The pieces on inputs made with numpy from a seed: the positional embedding
and ``PixelMemoryAttention`` (weights from the JAX package's init, carried
by ``state_dict_from_jax``) within 1e-4 relative in float32; the streaming
helpers index for index: ``_select_masked`` with tied hash scores and
fewer masked rows than ``k``, ``_ring_write`` across the ring's wrap,
``_pixels_in_boxes``, ``_irrelevant_pixels``, ``_coprime_stride`` and
``local_pixel_frame_offsets``.

Then the whole path: the MEGA config with ``ATTENTION.ENABLE`` off and both
pixel flags on, cut to depth 18, built by both packages' builders with the
JAX package's init conditioned and carried over;
``run_inference_video_arch`` of both packages on the ``mini_vid`` fixture's
first video at its own 160x240 (a res4 map of 10x16 pixels: the pixel
memories keep 100 pixels of a frame): frame by frame the labels and the
detection counts equal, scores and boxes within 1e-3 relative, the AP50s
equal; the port's test CLI gives the same predictions from the JAX tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.models import pixel_attention as jax_pixel
from diffusionvid_tpu.models import video_archs as jax_archs
from diffusionvid_tpu.ops.memory import FeatureMemory as JaxMemory

from diffusionvid_torch.models import pixel_attention, video_archs
from diffusionvid_torch.ops.memory import FeatureMemory
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_flow import cli_vs_jax, path_case, run_path_vs_jax
from test_torch_port_flow import _port_sub
from test_torch_port_inference import catalog_vid  # noqa: F401
from test_torch_port_rcnn import conditioned, one_thread, rel_err  # noqa: F401

RTOL = 1e-4


@pytest.mark.parametrize("h, w, d", [(10, 16, 1024), (3, 5, 8)])
def test_pixel_positional_embedding_matches(h, w, d):
    want = jax_pixel.pixel_positional_embedding(h, w, d)
    got = pixel_attention.pixel_positional_embedding(h, w, d)
    assert got.shape == (h, w, d)
    assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("with_keys", [False, True], ids=["self", "keys_and_memory"])
def test_pixel_memory_attention_matches(with_keys):
    """Self-attention over the map's own pixels, and attention over a key
    set with masked frames plus a memory with an unfilled tail."""
    rng = np.random.RandomState(3)
    feats = rng.randn(4, 5, 64).astype(np.float32)
    kw = {}
    if with_keys:
        kw = dict(keys=rng.randn(12, 64).astype(np.float32),
                  keys_valid=np.arange(12) % 4 != 3,
                  memory=rng.randn(7, 64).astype(np.float32), memory_valid=np.arange(7) < 5)
    mod = jax_pixel.PixelMemoryAttention(feat_dim=64)
    params = conditioned(jax.jit(lambda r: mod.init(r, feats, **kw))(
        jax.random.PRNGKey(2))["params"])
    want = mod.apply({"params": params}, feats, **kw)
    port = pixel_attention.PixelMemoryAttention(64)
    port.load_state_dict(_port_sub(params, "pixel_attn"), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert rel_err(got.numpy(), want) < RTOL
    assert rel_err(got.numpy(), feats) > 1e-2      # the residual moved the map


@pytest.mark.parametrize("n, k, masked", [(12, 5, 7), (12, 9, 4), (30, 30, 30), (40, 10, 0)],
                         ids=["ties", "fewer_masked_than_k", "all", "none"])
def test_select_masked_index_for_index(n, k, masked):
    """n = 12: the hash ``i * 2654435761 mod 2**32 mod 12`` repeats values,
    so the stable sort decides between tied rows."""
    rng = np.random.RandomState(n + k)
    px = rng.randn(n, 3).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:masked]] = True
    hashes = (np.arange(n, dtype=np.uint64) * 2654435761 % 2 ** 32) % n
    if n == 12:
        assert len(set(hashes.tolist())) < n
    for hashed in (True, False):
        want, wv = jax_archs._select_masked(jnp.asarray(px), jnp.asarray(mask), k, hashed)
        got, gv = video_archs._select_masked(torch.from_numpy(px), torch.from_numpy(mask), k,
                                             hashed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_irrelevant_pixels_and_stride():
    px = np.random.RandomState(4).randn(150, 16).astype(np.float32) * np.linspace(
        0.5, 2, 150, dtype=np.float32)[:, None]
    want, wv = jax_archs._irrelevant_pixels(jnp.asarray(px))
    got, gv = video_archs._irrelevant_pixels(torch.from_numpy(px))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < gv.sum() < 100
    for n, k, w in ((160, 16, 16), (2394, 239, 63), (150, 15, 15), (7, 20, 3)):
        assert video_archs._coprime_stride(n, k, w) == jax_archs._coprime_stride(n, k, w)


def test_ring_write_across_the_wrap():
    """A ring of 10 slots written 4, then 7 (3 valid), then 6 (5 valid) rows:
    the third write wraps past the end."""
    rng = np.random.RandomState(5)
    jmem = JaxMemory(jnp.zeros((10, 4)), jnp.asarray(0, jnp.int32))
    mem = FeatureMemory(torch.zeros(10, 4), 0)
    for rows, valid in ((4, np.ones(4, bool)), (7, np.arange(7) % 2 == 0),
                        (6, np.arange(6) != 2)):
        new = rng.randn(rows, 4).astype(np.float32)
        jmem = jax_archs._ring_write(jmem, jnp.asarray(new), jnp.asarray(valid))
        mem = video_archs._ring_write(mem, torch.from_numpy(new), torch.from_numpy(valid))
        assert mem.count == int(jmem.count)
        np.testing.assert_array_equal(mem.feats.numpy(), np.asarray(jmem.feats))
        np.testing.assert_array_equal(video_archs._ring_valid(mem).numpy(),
                                      np.asarray(jax_archs._ring_valid(jmem)))
    assert mem.count == 13


def test_pixels_in_boxes_matches():
    rng = np.random.RandomState(6)
    xy = rng.uniform(-20, 200, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 90, (9, 2))], 1).astype(np.float32)
    boxes[0] = (24.0, 8.0, 56.0, 40.0)      # edges on pixel centres (x 1.5..3.5, y 0.5..2.5)
    valid = np.arange(9) != 4
    want = jax_archs._pixels_in_boxes(10, 16, jnp.asarray(boxes), jnp.asarray(valid))
    got = video_archs._pixels_in_boxes(10, 16, torch.from_numpy(boxes), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < 160
    # x against x: a wide flat box covers one row of pixels, not one column
    flat = video_archs._pixels_in_boxes(10, 16, torch.tensor([[0.0, 20.0, 255.0, 28.0]]),
                                        torch.tensor([True])).reshape(10, 16)
    assert flat[1].all() and flat.sum() == 16


@pytest.mark.parametrize("kw", [{}, dict(interval=19, key_location=9),
                                dict(sel_future=3, sel_prev=4, interval=9, key_location=2)])
def test_local_pixel_frame_offsets(kw):
    got = video_archs.local_pixel_frame_offsets(**kw)
    assert got == jax_archs.local_pixel_frame_offsets(**kw)
    if not kw:
        assert got == [-12, -8, -4, -2, -1, 0, 1, 2, 4, 8, 12]


# ---------------------------------------------------------------- the whole path

PIXEL_TINY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "5",
              "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100", "MODEL.RPN.POST_NMS_TOP_N_TEST", "8",
              "INPUT.MIN_SIZE_TEST", "160", "INPUT.MAX_SIZE_TEST", "240",
              "INPUT.INFER_BATCH", "4", "MODEL.VID.MEGA.GLOBAL.SIZE", "3",
              "TPU.COMPUTE_DTYPE", "float32", "MODEL.WEIGHT", "''"]
# the pixel memory at 200 rows: the 3 global frames' 160 pixels each overflow
# it, so its FPS runs; the box memory at 8 slots
PIXEL_PATHS = {"mega_pixel": ("configs/MEGA/vid_R_101_C4_MEGA_1x.yaml", [
    "MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "False",
    "MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND", "True", "MODEL.VID.MEGA.GLOBAL.PIXEL_ATTEND", "True",
    "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "8",
    "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_PIXEL_TEST", "200"])}


def test_pixel_path_vs_jax(mini_vid):  # noqa: F811
    run_path_vs_jax("mega_pixel", mini_vid, PIXEL_PATHS, PIXEL_TINY)
    config, extra = PIXEL_PATHS["mega_pixel"]
    model = path_case(config, tuple(PIXEL_TINY + extra))[4]
    assert model.pixel_replaces_box and model.pixel_attend_global
    assert model.relation_stages == 0 and hasattr(model, "global_lm")


def test_pixel_path_cli_vs_jax(mini_vid, catalog_vid, tmp_path, monkeypatch):  # noqa: F811
    cli_vs_jax("mega_pixel", mini_vid, catalog_vid, tmp_path, monkeypatch, PIXEL_PATHS,
               PIXEL_TINY)


def test_pixel_caches_fill(mini_vid):  # noqa: F811
    """The port's caches after the primed state and one frame: the pixel
    memory thinned to its 200 rows by FPS, the box memory full, and the
    frame's pixels in the rings."""
    from diffusionvid_torch.engine.inference_mega import (
        PixelVideoState, detect_frame, prime_state)
    config, extra = PIXEL_PATHS["mega_pixel"]
    model = path_case(config, tuple(PIXEL_TINY + extra))[4]
    frames = torch.from_numpy(np.random.RandomState(7).uniform(0, 255, (4, 160, 240, 3))
                              .astype(np.float32))
    hw = (160.0, 240.0)
    whwh = torch.tensor([240.0, 160.0, 240.0, 160.0])
    with torch.no_grad():
        state = prime_state(model, "mega", frames[:3], whwh, hw)
        assert isinstance(state, PixelVideoState)
        assert state.pixel.gpix.count == 200 and state.box.mem.count == 8
        assert int(state.pixel.irr_g_valid.sum()) > 0
        _, state = detect_frame(model, "mega", frames, 1, state, whwh, hw,
                                pixel_offsets=video_archs.local_pixel_frame_offsets())
    assert int(state.pixel.irr_valid.sum()) > 0
