"""The port's host library ``csrc/vidkit.cpp`` against the Python paths and
the JAX package.

The library (``diffusionvid_torch/native.py``) and the port's Python paths
(``native=False``) of seq-NMS and of the evaluator's matching, and the JAX
package's library (``native/libvidkit.so``) and Python paths (its library
hidden by patching ``diffusionvid_tpu.native.get_lib``), on seeded random
videos: frames without boxes, classes without GT, exact IoU ties (duplicate
GT and prediction boxes) and score ties, chains broken by suppression.
Everything is required equal: keep masks, matches, ignored shares, chain
roots and paths bit for bit, scores and chain sums bit for bit.
"""

import numpy as np
import pytest

from diffusionvid_tpu import native as jax_native
from diffusionvid_tpu.engine import seq_nms as jax_seq_nms
from diffusionvid_tpu.evaluation import vid_eval as jax_eval

from diffusionvid_torch import native
from diffusionvid_torch.engine import seq_nms
from diffusionvid_torch.evaluation import vid_eval
from diffusionvid_torch.ops import _build
from test_torch_port_eval import make_case, make_video

SEEDS = [0, 1, 2, 3]


def _tied_case(seed: int, frames: int = 24, classes: int = 4):
    """``make_case``'s frames with exact ties added: each frame repeats a GT
    box (equal IoUs with every prediction, one of the pair ignored by the
    motion IoUs) and a prediction with its score."""
    gts, preds, motion = make_case(seed, frames, classes)
    rng = np.random.RandomState(100 + seed)
    for g, p, m in zip(gts, preds, motion):
        if len(g["boxes"]):
            g["boxes"] = np.concatenate([g["boxes"], g["boxes"][:1]])
            g["labels"] = np.concatenate([g["labels"], g["labels"][:1]])
            m[:] = rng.uniform(0.5, 1.0, len(m))
            m.resize(len(g["boxes"]), refcheck=False)
            m[-1] = 0.95 if m[0] < 0.9 else 0.6        # one of the pair in the bucket
        if len(p["boxes"]):
            for key in ("boxes", "scores", "labels"):
                p[key] = np.concatenate([p[key], p[key][:1]])
            p.pop("objectness", None)
    return gts, preds, motion


def _frame_cases(seed: int):
    """(pred boxes sorted by score, GT boxes, GT ignore) of one class per
    frame, over a tied case's frames, and one frame without GT."""
    gts, preds, motion = _tied_case(seed)
    out = []
    for g, p, m in zip(gts, preds, motion):
        labels = np.unique(np.concatenate([g["labels"], p["labels"]]))
        for lab in labels:
            pm, gm = p["labels"] == lab, g["labels"] == lab
            order = p["scores"][pm].argsort()[::-1]
            ignore = ((m < 0.7) | (m > 0.9)).astype(np.float64)[gm]
            out.append((p["boxes"][pm][order].astype(np.float64),
                        g["boxes"][gm].astype(np.float64), ignore))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_match_frame_vs_jax_library(seed):
    cases = _frame_cases(seed)
    assert any(len(gb) == 0 for _, gb, _ in cases) and any(len(pb) == 0 for pb, _, _ in cases)
    for pb, gb, gi in cases:
        for empty in (0.0, 0.25):
            got = native.match_frame_native(pb, gb, gi, 0.5, empty)
            want = jax_native.match_frame_native(pb, gb, gi, 0.5, empty)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("motion_range", [(0.0, 1.0), (0.7, 0.9)], ids=["all", "medium"])
def test_match_predictions_native_equals_python(seed, motion_range):
    gts, preds, motion = _tied_case(seed)
    got = vid_eval.match_predictions(gts, preds, motion, 0.5, motion_range, native=True)
    want = vid_eval.match_predictions(gts, preds, motion, 0.5, motion_range, native=False)
    for g, w in zip(got, want):
        assert dict(g) == dict(w)
    _, _, match, pred_ig = got
    assert sum(sum(m) for m in match.values()) > 0            # some matches
    if motion_range != (0.0, 1.0):                            # some ignored GT matched
        assert any(x == 1.0 for v in pred_ig.values() for x in v)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("native_path", [True, False], ids=["native", "python"])
def test_calc_prec_rec_vs_jax_both_paths(seed, native_path, monkeypatch):
    """The port's curves, on either path, equal the JAX package's on both
    of its paths, bit for bit."""
    gts, preds, motion = _tied_case(seed)
    rng = (0.7, 0.9)
    prec, rec = vid_eval.calc_prec_rec(gts, preds, motion, 0.5, rng, 6, native=native_path)
    want = [jax_eval.calc_prec_rec(gts, preds, motion, 0.5, rng, 6)]
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    want.append(jax_eval.calc_prec_rec(gts, preds, motion, 0.5, rng, 6))
    for jprec, jrec in want:
        for a, b in zip(prec + rec, jprec + jrec):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def _flat(video, label):
    boxes = [fr["boxes"][fr["labels"] == label].astype(np.float64) for fr in video]
    scores = [fr["scores"][fr["labels"] == label].astype(np.float64) for fr in video]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in scores])]).astype(np.int32)
    return boxes, scores, offsets


@pytest.mark.parametrize("seed", SEEDS)
def test_max_chain_vs_jax_library_and_python(seed):
    """Chain by chain, with boxes killed between searches as seq-NMS kills
    them: the port's library, the JAX package's and the Python dynamic
    program give the same root, path and sum."""
    video = make_video(seed)
    rng = np.random.RandomState(seed)
    for label in (1, 2, 3):
        boxes, scores, offsets = _flat(video, label)
        if offsets[-1] == 0:
            continue
        flat_b, flat_s = np.concatenate(boxes), np.concatenate(scores)
        dead = [np.zeros(len(s), bool) for s in scores]
        links = seq_nms._build_links(boxes)
        for _ in range(4):
            flat_d = np.concatenate(dead).astype(np.uint8)
            got = native.max_chain_native(flat_b, flat_s, flat_d, offsets, seq_nms.LINK_IOU)
            want = jax_native.max_chain_native(flat_b, flat_s, flat_d, offsets,
                                               seq_nms.LINK_IOU)
            assert got == want
            root, path, total = seq_nms._max_path(links, scores, dead)
            assert got[0] == root and got[2] == total
            assert [g - int(offsets[root + i]) for i, g in enumerate(got[1])] == path
            # kill a random alive third (a suppression) and drop them from the links
            for f in range(len(dead)):
                kill = (rng.rand(len(dead[f])) < 0.3) & ~dead[f]
                dead[f] |= kill
                if f < len(links):
                    for i in np.nonzero(kill)[0]:
                        links[f][i] = []
                if f > 0:
                    links[f - 1] = [[j for j in nx if not kill[j]] for nx in links[f - 1]]


def _equal_videos(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("boxes", "scores", "labels"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("seed", SEEDS)
def test_seq_nms_video_native_python_jax(seed, monkeypatch):
    """``seq_nms_video`` end to end: the port's library and Python paths and
    the JAX package's library and Python paths, bit for bit.  Seed 3's
    video has tied scores."""
    video = make_video(seed)
    if seed == 3:
        for fr in video:
            fr["scores"] = np.round(fr["scores"] * 4) / 4 + np.float32(0.125)
    got = seq_nms.seq_nms_video(video, native=True)
    _equal_videos(got, seq_nms.seq_nms_video(video, native=False))
    _equal_videos(got, jax_seq_nms.seq_nms_video(video))
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    _equal_videos(got, jax_seq_nms.seq_nms_video(video))
    assert sum(len(g["scores"]) for g in got) < sum(len(v["scores"]) for v in video)


def test_seq_nms_class_empty_frames_and_broken_chains():
    """A class whose boxes skip frames (empty frames break the chains) and
    whose chains suppress their neighbours: both paths keep and rescore the
    same boxes, and some chain is broken by an empty frame."""
    rng = np.random.RandomState(11)
    boxes, scores = [], []
    for f in range(12):
        if f in (3, 4, 8):
            boxes.append(np.zeros((0, 4)))
            scores.append(np.zeros(0))
            continue
        base = np.array([[10, 10, 60, 60], [100, 40, 160, 120]], np.float64) + f
        near = base + rng.uniform(-5, 5, base.shape)
        boxes.append(np.concatenate([base, near]))
        scores.append(rng.uniform(0.05, 1.0, 4))
    keep, new = seq_nms.seq_nms_class(boxes, scores, native=True)
    pkeep, pnew = seq_nms.seq_nms_class(boxes, scores, native=False)
    jkeep, jnew = jax_seq_nms.seq_nms_class(boxes, scores)
    for a, b, c, x, y, z in zip(keep, pkeep, jkeep, new, pnew, jnew):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert not all(k.all() for k in keep)                       # suppressed some
    assert len({float(s[k][0]) for s, k in zip(new, keep) if k.any()}) > 1


def test_zero_score_chain_library_equals_jax_library():
    """A chain through alive boxes of score 0 (ROADMAP.md C): both libraries
    extend a chain through them, where both Python paths start it at the
    first positive score; the port keeps the JAX package's arithmetic on
    either path.  ``run_inference`` keeps only positive scores, so its
    predictions never hold such a box."""
    boxes = [np.array([[0, 0, 10, 10.]])] * 3
    scores = [np.array([0.0]), np.array([0.0]), np.array([0.5])]
    lib = seq_nms.seq_nms_class(boxes, scores, native=True)[1]
    py = seq_nms.seq_nms_class(boxes, scores, native=False)[1]
    np.testing.assert_array_equal(np.concatenate(lib),
                                  np.concatenate(jax_seq_nms.seq_nms_class(boxes, scores)[1]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "get_lib", lambda: None)
        jpy = jax_seq_nms.seq_nms_class(boxes, scores)[1]
    np.testing.assert_array_equal(np.concatenate(py), np.concatenate(jpy))
    np.testing.assert_array_equal(np.concatenate(lib), np.float32([0.5 / 3] * 3))
    np.testing.assert_array_equal(np.concatenate(py), np.float32([0, 0, 0.5]))


def test_bindings_refuse_mismatched_arrays():
    """The bindings check the sizes before they pass pointers."""
    box = np.zeros((2, 4))
    with pytest.raises(ValueError, match="ignore flags"):
        native.match_frame_native(box, box, np.zeros(3), 0.5, 0.0)
    with pytest.raises(ValueError, match="dead flags"):
        native.max_chain_native(box, np.ones(2), np.zeros(1, np.uint8), [0, 1, 2], 0.5)
    with pytest.raises(ValueError, match="never decrease"):
        native.max_chain_native(box, np.ones(2), np.zeros(2, np.uint8), [0, 2, 1, 2], 0.5)


def test_host_build_flags_and_target():
    """``g++`` without -march=native and with -ffp-contract=off, into the
    build directory under a name hashing the source and the flags; the
    ``.cu`` list does not hold it."""
    assert "-ffp-contract=off" in _build.GXX_FLAGS
    assert not any(f.startswith("-march") for f in _build.GXX_FLAGS)
    assert "vidkit" not in _build.sources()
    native.get_lib()
    path = native.library_path()
    assert path is not None and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libvidkit-") and path == _build.host_target("vidkit")


def test_host_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text('extern "C" int f() { return undefined_name; }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undefined_name"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))
