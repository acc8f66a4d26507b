"""The port's VID evaluator and seq-NMS against the JAX package.

Seeded per-frame GT and predictions (empty frames, frames with GT and no
prediction, jittered hits, clutter, tied scores), with and without random
motion IoUs (so some GTs are ignored in each bucket): ``evaluate_vid``,
``calc_prec_rec`` with ``calc_ap`` in both metrics, ``eval_proposals`` and
``corloc`` equal within 1e-9; ``load_motion_iou_mat`` on a written .mat file;
``seq_nms_video`` on seeded multi-class videos with overlapping chains.
"""

import numpy as np
import pytest

from diffusionvid_tpu.engine import seq_nms as jax_seq_nms
from diffusionvid_tpu.evaluation import vid_eval as jax_eval

from diffusionvid_torch.engine import seq_nms
from diffusionvid_torch.evaluation import vid_eval

TOL = 1e-9


def _boxes(rng, n, w=320.0, h=240.0):
    xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
    return np.concatenate([xy, xy + rng.uniform(8, 120, (n, 2))], 1).clip(0, [w, h] * 2)


def make_case(seed: int, frames: int = 40, classes: int = 6):
    """Per-frame GT and predictions, and per-GT motion IoUs."""
    rng = np.random.RandomState(seed)
    gts, preds, motion = [], [], []
    for f in range(frames):
        n = 0 if f % 7 == 3 else rng.randint(1, 5)
        gb = _boxes(rng, n).astype(np.float32)
        gl = rng.randint(1, classes + 1, n).astype(np.int32)
        gts.append({"boxes": gb, "labels": gl})
        motion.append(rng.uniform(0.5, 1.0, n))
        if f % 11 == 5:
            preds.append({"boxes": np.zeros((0, 4), np.float32),
                          "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)})
            continue
        hit = rng.rand(n) < 0.7
        pb = np.concatenate([gb[hit] + rng.uniform(-6, 6, (hit.sum(), 4)),
                             _boxes(rng, rng.randint(0, 8))]).astype(np.float32)
        pl = np.concatenate([gl[hit], rng.randint(1, classes + 1, len(pb) - hit.sum())])
        scores = rng.choice([0.2, 0.5, 0.9], len(pb)) if f % 5 == 0 else rng.rand(len(pb))
        preds.append({"boxes": pb, "scores": scores.astype(np.float32),
                      "labels": pl.astype(np.int64)})
        if f % 4 == 0:
            preds[-1]["objectness"] = rng.rand(len(pb)).astype(np.float32)
    return gts, preds, motion


CASES = [0, 1, 2]


@pytest.mark.parametrize("seed", CASES)
@pytest.mark.parametrize("motion", [False, True], ids=["plain", "motion"])
def test_evaluate_vid_vs_jax(seed, motion):
    gts, preds, mious = make_case(seed)
    kw = dict(motion_ious=mious if motion else None, motion_specific=motion)
    got, want = vid_eval.evaluate_vid(gts, preds, **kw), jax_eval.evaluate_vid(gts, preds, **kw)
    assert set(got["per_motion"]) == set(want["per_motion"]) == (
        {"all", "fast", "medium", "slow"} if motion else {"all"})
    for k, v in want["per_motion"].items():
        assert abs(got["per_motion"][k] - v) <= TOL, k
    assert abs(got["ap50"] - want["ap50"]) <= TOL and 0 < got["ap50"] < 1
    np.testing.assert_allclose(got["ap"], want["ap"], atol=TOL, equal_nan=True)
    assert abs(got["corloc"] - want["corloc"]) <= TOL


@pytest.mark.parametrize("seed", CASES)
@pytest.mark.parametrize("use_07", [False, True], ids=["area", "voc07"])
def test_calc_ap_vs_jax(seed, use_07):
    gts, preds, mious = make_case(seed)
    for rng in jax_eval.MOTION_RANGES:
        prec, rec = vid_eval.calc_prec_rec(gts, preds, mious, 0.5, rng, 6)
        jprec, jrec = jax_eval.calc_prec_rec(gts, preds, mious, 0.5, rng, 6)
        for p, jp in zip(prec + rec, jprec + jrec):
            assert (p is None) == (jp is None)
            if p is not None:
                np.testing.assert_allclose(p, jp, atol=TOL)
        np.testing.assert_allclose(vid_eval.calc_ap(prec, rec, use_07),
                                   jax_eval.calc_ap(jprec, jrec, use_07),
                                   atol=TOL, equal_nan=True)


@pytest.mark.parametrize("seed", CASES)
def test_eval_proposals_and_corloc_vs_jax(seed):
    gts, preds, _ = make_case(seed)
    for limit in (300, 3):
        got = vid_eval.eval_proposals(gts, preds, limit=limit)["recall"]
        assert abs(got - jax_eval.eval_proposals(gts, preds, limit=limit)["recall"]) <= TOL
    per, avg = vid_eval.corloc(gts, preds)
    jper, javg = jax_eval.corloc(gts, preds)
    assert per.keys() == jper.keys() and abs(avg - javg) <= TOL
    for k in per:
        assert abs(per[k] - jper[k]) <= TOL


def test_load_motion_iou_mat_vs_jax(tmp_path):
    """The reference's cell layout: one cell a frame, one value a GT, an
    empty cell for a GT without a motion IoU."""
    import scipy.io as sio
    rng = np.random.RandomState(4)
    cells = np.empty((5, 1), dtype=object)
    for i, n in enumerate((2, 0, 3, 1, 2)):
        row = np.empty((n,), dtype=object)
        for j in range(n):
            row[j] = np.zeros((0,)) if (i, j) == (2, 1) else np.asarray([rng.rand()])
        cells[i, 0] = row
    path = str(tmp_path / "motion.mat")
    sio.savemat(path, {"motion_iou": cells})
    got, want = vid_eval.load_motion_iou_mat(path), jax_eval.load_motion_iou_mat(path)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float64), np.asarray(w, np.float64))


def make_video(seed: int, frames: int = 12, classes: int = 4):
    """Tracks that drift a little each frame (chains), near-duplicates of
    them (suppressed), clutter, and frames where a class is absent."""
    rng = np.random.RandomState(seed)
    tracks = [(rng.randint(1, classes + 1), _boxes(rng, 1)[0], rng.uniform(-4, 4, 4))
              for _ in range(5)]
    out = []
    for f in range(frames):
        boxes, scores, labels = [], [], []
        for label, box, speed in tracks:
            if rng.rand() < 0.15:
                continue
            b = box + f * speed + rng.uniform(-2, 2, 4)
            boxes += [b, b + rng.uniform(-8, 8, 4)]
            scores += list(rng.uniform(0.05, 1.0, 2))
            labels += [label, label]
        clutter = rng.randint(0, 6)
        boxes += list(_boxes(rng, clutter))
        scores += list(rng.uniform(0.001, 0.3, clutter))
        labels += list(rng.randint(1, classes + 1, clutter))
        out.append({"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                    "scores": np.asarray(scores, np.float32),
                    "labels": np.asarray(labels, np.int64)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seq_nms_video_vs_jax(seed):
    video = make_video(seed)
    got, want = seq_nms.seq_nms_video(video), jax_seq_nms.seq_nms_video(video)
    assert len(got) == len(want) == len(video)
    changed = 0
    for g, w, v in zip(got, want, video):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=TOL)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL)
        changed += len(g["scores"]) < len(v["scores"])
    assert changed > 0   # some boxes were suppressed


def test_seq_nms_class_vs_jax():
    video = make_video(7)
    boxes = [fr["boxes"][fr["labels"] == 1] for fr in video]
    scores = [fr["scores"][fr["labels"] == 1] for fr in video]
    keep, rescored = seq_nms.seq_nms_class(boxes, scores)
    jkeep, jrescored = jax_seq_nms.seq_nms_class(boxes, scores)
    for k, jk, s, js in zip(keep, jkeep, rescored, jrescored):
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_allclose(s, js, atol=TOL)
