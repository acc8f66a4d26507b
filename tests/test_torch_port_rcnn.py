"""The MEGA family's pieces in the port against the JAX package.

On shared inputs and weights (made with numpy from a seed): ``nms_select``
index for index (tied scores, invalid boxes, fewer survivors than k), the
anchors, ``select_proposals``, the single-level ``roi_align``, the C4 box
head and ``postprocess_classic``, ``RelationStack`` (RDN's, with the
advanced stages, MEGA's joint stages with the global memory and the stage
rings), and the four architectures (``GeneralizedRCNN``, ``RDNArch``,
``MEGAArch``, ``SparseRCNNDAFA``) at depth 18 on 64x96 frames: equal
selections (labels, valid masks), the values before any selection within
1e-4 relative in float32 (MEGA's logits 3e-4, ``MEGA_RTOL``) and the
detections after them within 1e-3.  Also the builder (DFF, FGFA, ResNeXt and
the pixel flags as the JAX package builds them), its refusals of what is not
ported, and the weight carry-over's names.

``jax_rcnn_params`` builds every C4 architecture's tree from one jitted JAX
``RDNArch`` init (about 12 s; cached, as is DAFA's, for the other file in
the same process): the relation stack of RDN with an advanced
stage holds every relation layer the others use.  ``conditioned`` brings
the JAX package's initial weights to a scale where the trunk's maps, the
attention and the logits are O(1) and the scores spread (no near-ties for
the selections to break): the convolutions get variance 1/fan-in, the
head's biases and LayerNorm affines a seeded perturbation.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.models import box_head as jax_box_head
from diffusionvid_tpu.models import relation as jax_relation
from diffusionvid_tpu.models import rpn as jax_rpn
from diffusionvid_tpu.models.dafa import SparseRCNNDAFA as JaxDAFA
from diffusionvid_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from diffusionvid_tpu.models.video_archs import MEGAArch as JaxMEGA
from diffusionvid_tpu.models.video_archs import RDNArch as JaxRDN
from diffusionvid_tpu.ops import nms as jax_nms
from diffusionvid_tpu.ops.roi_align import roi_align as jax_roi_align

from diffusionvid_torch.config import load_config
from diffusionvid_torch.models import box_head, relation, rpn
from diffusionvid_torch.models.dafa import SparseRCNNDAFA
from diffusionvid_torch.models.detectors import build_detection_model
from diffusionvid_torch.models.rcnn import GeneralizedRCNN
from diffusionvid_torch.models.video_archs import MEGAArch, RDNArch
from diffusionvid_torch.ops.nms import nms_select
from diffusionvid_torch.ops.roi_align import roi_align
from diffusionvid_torch.utils.convert import state_dict_from_jax
from test_torch_port_weights import one_thread, rel_err  # noqa: F401  (one_thread: the fixture)

H, W = 64, 96
CLASSES = 5
# the C4 models' selections at this size: 288 anchors, 100 before the NMS,
# 8 current proposals, 4 a reference frame; the stage rings push the last
# 75 reference rows a frame, so their model takes 25 from each of 3 frames
RCNN = dict(depth=18, num_classes=CLASSES)
NMS = dict(pre_nms=100, post_nms=8, ref_post_nms=4, advanced_num=2)
NMS_RINGS = dict(NMS, ref_post_nms=25)
DAFA = dict(depth=18, num_classes=CLASSES, num_proposals=16, memory_size=16, top_k=16)
RTOL = 1e-4
# MEGA's logits: its joint stages key the current rows on the reference
# rows and the memories through the geometric bias log(relu(emb . Wg) + 1e-6),
# whose embedding takes sin/cos of 100 x the boxes' log ratios; the boxes'
# 1e-6 differences from the trunk come out at 1.1e-4 to 1.5e-4 (measured
# with the geometry weights scaled 3, 30 and 300 times)
MEGA_RTOL = 3e-4


def conditioned(tree, seed: int = 0):
    """Convolutions at variance 1/fan-in; the relation's value and
    geometry weights scaled up; head biases and norms perturbed; DAFA's
    class biases near zero."""
    noise = np.random.RandomState(seed)

    def scale(path, a):
        a = np.array(a, np.float32)
        where = "/".join(str(k) for k in path)
        top, name = str(path[0]), str(path[-1])
        if a.ndim == 4:
            return (a / a.std() * np.sqrt(1.0 / np.prod(a.shape[1:]))).astype(np.float32)
        if "Wv_weight" in name:      # normal(0.01) → about 1/sqrt(1024)
            return a * np.float32(3.0)
        if "Wg_weight" in name:      # a geometric bias that moves the softmax
            return a * np.float32(30.0)
        if "class_logits_bias" in name:    # DAFA's scores from the prior 0.01 to about 0.5
            return np.float32(0.2) * noise.randn(*a.shape).astype(np.float32)
        if a.ndim == 1 and "backbone" not in where and "fpn" not in where and (
                "bias" in name or "head" in top):
            return a + np.float32(0.2) * noise.randn(*a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _sub(tree, keys):
    return {k: tree[k] for k in keys}


@functools.lru_cache(maxsize=None)
def jax_rcnn_params(seed: int = 0) -> dict:
    """The C4 architectures' JAX parameter trees from one RDN init:
    ``rdn_adv`` (2 stages + 1 advanced), ``rdn`` (2 stages), ``mega3`` (3
    joint stages), ``mega0`` (no stage: ``global_lm``) and ``base``
    (``GeneralizedRCNN``, its predictor drawn here)."""
    model = JaxRDN(**RCNN, **NMS, relation_stages=2, advanced_stages=1)
    zeros = jnp.zeros((1, H, W, 3))
    init = jax.jit(lambda r: model.init(r, zeros, jnp.zeros((2, H, W, 3)), (H, W)))
    p = conditioned(init(jax.random.PRNGKey(seed))["params"], seed)
    rel = p["relation"]
    rng = np.random.RandomState(seed + 1)

    def linear(n_out, n_in):
        return {"weight": (rng.randn(n_out, n_in) / np.sqrt(n_in)).astype(np.float32),
                "bias": (0.2 * rng.randn(n_out)).astype(np.float32)}

    common = _sub(p, ("detector", "reduce", "predictor"))
    lm = {k: v for k, v in rel["attn0"].items() if not k.startswith("Wg")}
    return {
        "rdn_adv": p,
        "rdn": {**common, "relation": _sub(rel, ("fc0", "fc1", "attn0", "attn1"))},
        "mega3": {**common, "relation": _sub(rel, ("fc0", "fc1", "fc2", "attn0", "attn1",
                                                   "attn2"))},
        "mega0": {**common, "global_lm": lm},
        "base": {**p["detector"], "predictor": {
            "cls_score": linear(CLASSES, 2048), "bbox_pred": linear(4 * CLASSES, 2048)}},
    }


@functools.lru_cache(maxsize=None)
def jax_dafa_params(seed: int = 0, res_stage: int = 2) -> dict:
    model = JaxDAFA(**DAFA, res_stage=res_stage)
    whwh = jnp.asarray([W, H, W, H], jnp.float32)
    init = jax.jit(lambda r: model.init(r, jnp.zeros((1, H, W, 3)), whwh,
                                        state=model.init_state()))
    return conditioned(init(jax.random.PRNGKey(seed))["params"], seed)


JAX_MODELS = {
    "base": lambda: JaxRCNN(**RCNN, pre_nms_test=100, post_nms_test=8, ref_post_nms=4),
    "rdn": lambda: JaxRDN(**RCNN, **NMS, relation_stages=2),
    "rdn_adv": lambda: JaxRDN(**RCNN, **NMS, relation_stages=2, advanced_stages=1),
    "mega3": lambda: JaxMEGA(**RCNN, **NMS, relation_stages=3, memory_size=8, mem_frames=2),
    "mega3_mem": lambda: JaxMEGA(**RCNN, **NMS_RINGS, relation_stages=3, memory_size=8,
                                 mem_frames=2, use_stage_mem=True),
    "mega0": lambda: JaxMEGA(**RCNN, **NMS, relation_stages=0, memory_size=8),
}
PORT_MODELS = {
    "base": lambda: GeneralizedRCNN(**RCNN, pre_nms_test=100, post_nms_test=8,
                                    ref_post_nms=4),
    "rdn": lambda: RDNArch(**RCNN, **NMS, relation_stages=2),
    "rdn_adv": lambda: RDNArch(**RCNN, **NMS, relation_stages=2, advanced_stages=1),
    "mega3": lambda: MEGAArch(**RCNN, **NMS, relation_stages=3, memory_size=8, mem_frames=2),
    "mega3_mem": lambda: MEGAArch(**RCNN, **NMS_RINGS, relation_stages=3, memory_size=8,
                                  mem_frames=2, use_stage_mem=True),
    "mega0": lambda: MEGAArch(**RCNN, **NMS, relation_stages=0, memory_size=8),
}
PARAMS_OF = {"mega3_mem": "mega3"}


def port_of(kind: str, tree) -> torch.nn.Module:
    """The port's CPU fp32 model of ``kind`` with the JAX tree loaded
    strictly."""
    model = (SparseRCNNDAFA(**DAFA, res_stage=2) if kind == "dafa" else PORT_MODELS[kind]())
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def rcnn_params():
    return jax_rcnn_params()


def _images(seed, n):
    return np.random.RandomState(seed).uniform(0, 255, (n, H, W, 3)).astype(np.float32)


# ---------------------------------------------------------------- ops

def _nms_case(seed, n, ties: bool):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[::7] = boxes[1::7][:len(boxes[::7])]          # duplicates: IoU 1
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4                   # five distinct values
    valid = rng.uniform(0, 1, n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("case", [
    dict(seed=0, n=60, k=20, thr=0.5, ties=True, plus_one=True),
    dict(seed=1, n=60, k=80, thr=0.3, ties=True, plus_one=False),
    dict(seed=2, n=200, k=50, thr=0.7, ties=False, plus_one=True),
    dict(seed=3, n=9, k=16, thr=0.0, ties=True, plus_one=True),
], ids=["ties", "fewer_than_k", "many", "all_suppress"])
def test_nms_select_index_for_index(case):
    boxes, scores, valid = _nms_case(case["seed"], case["n"], case["ties"])
    scores_m = np.where(valid, scores, -np.inf).astype(np.float32)
    fn = jax.jit(jax_nms.nms_select, static_argnums=(2, 3, 5))
    want_i, want_v = fn(jnp.asarray(boxes), jnp.asarray(scores_m), case["k"], case["thr"],
                        jnp.asarray(valid), case["plus_one"])
    got_i, got_v = nms_select(torch.from_numpy(boxes), torch.from_numpy(scores_m), case["k"],
                              case["thr"], valid=torch.from_numpy(valid),
                              plus_one=case["plus_one"])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if case["k"] > case["n"]:
        assert not got_v.numpy().all() and (got_i.numpy()[~got_v.numpy()] == 0).all()


def test_nms_select_breaks_ties_by_the_lower_index():
    boxes = torch.tensor([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 10, 10.0]])
    idx, ok = nms_select(boxes, torch.tensor([0.5, 0.5, 0.5]), 3, 0.5)
    assert idx.tolist() == [0, 1, 0] and ok.tolist() == [True, True, False]


def test_anchors_match():
    for sizes, ratios, stride in (((64, 128, 256, 512), (0.5, 1.0, 2.0), 16),
                                  ((32, 64), (1.0,), 8)):
        base = rpn.generate_anchors(sizes, ratios, stride)
        np.testing.assert_array_equal(base, jax_rpn.generate_anchors(sizes, ratios, stride))
        np.testing.assert_array_equal(rpn.shift_anchors(base, 3, 5, stride),
                                      jax_rpn.shift_anchors(base, 3, 5, stride))


@pytest.mark.parametrize("post", [16, 75])
def test_select_proposals_match(post):
    rng = np.random.RandomState(post)
    hf, wf, a = 4, 6, 12
    logits = rng.randn(2, hf, wf, a).astype(np.float32)
    logits[0, 1:3, 1:4] = logits[0, 1, 1]                  # tied objectness
    deltas = (0.5 * rng.randn(2, hf, wf, 4 * a)).astype(np.float32)
    anchors = rpn.shift_anchors(rpn.generate_anchors(), hf, wf, 16)
    kw = dict(pre_nms=100, post_nms=post)
    want = jax.jit(lambda lg, dl: jax_rpn.select_proposals(
        lg, dl, jnp.asarray(anchors), (H, W), **kw))(logits, deltas)
    got = rpn.select_proposals(torch.from_numpy(logits), torch.from_numpy(deltas),
                               torch.from_numpy(anchors), (H, W), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert rel_err(got.scores.numpy(), want.scores) == 0
    assert rel_err(got.boxes.numpy(), want.boxes) < 1e-6


def test_roi_align_single_level_matches():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 5, 7, 32).astype(np.float32)
    xy = rng.uniform(-20, 100, (2, 9, 2))
    rois = np.concatenate([xy, xy + rng.uniform(1, 60, (2, 9, 2))], -1).astype(np.float32)
    want = jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), 1.0 / 16,
                                   output_size=14, sampling_ratio=2)
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 1.0 / 16, chunk=4)
    assert got.shape == (2, 9, 14, 14, 32)
    assert rel_err(got.numpy(), want) < 1e-6


def test_c4_head_and_postprocess_match(rcnn_params):
    """The C4 extractor (ROIAlign 14x14 → res5 with RES5_DILATION 2 → mean)
    and the predictor on res4-sized maps, then ``postprocess_classic``."""
    tree = rcnn_params["base"]
    rng = np.random.RandomState(3)
    feat = rng.randn(1, 4, 6, 1024).astype(np.float32)
    xy = rng.uniform(0, 60, (1, 12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (1, 12, 2))], -1).astype(np.float32)
    valid = rng.uniform(0, 1, (1, 12)) > 0.2
    for dilation in (1, 2):
        jext = jax_box_head.C4BoxFeatureExtractor(depth=18, dilation=dilation)
        want = jax.jit(lambda f, b: jext.apply({"params": tree["roi_head"]}, f, b))(feat, boxes)
        ext = box_head.C4BoxFeatureExtractor(18, dilation)
        ext.load_state_dict({k[len("roi_head."):]: v for k, v in state_dict_from_jax(
            {"roi_head": tree["roi_head"]}).items()}, strict=True)
        with torch.no_grad():
            got = ext(torch.from_numpy(feat), torch.from_numpy(boxes))
        assert rel_err(got.numpy(), want) < RTOL
    jpred = jax_box_head.FastRCNNPredictor(CLASSES)
    cl, bd = jpred.apply({"params": tree["predictor"]}, want)
    dets = jax.jit(lambda c, d, b, v: jax_box_head.postprocess_classic(
        c, d, b, v, (H, W)))(cl[0], bd[0], boxes[0], valid[0])
    got = box_head.postprocess_classic(torch.from_numpy(np.asarray(cl[0])),
                                       torch.from_numpy(np.asarray(bd[0])),
                                       torch.from_numpy(boxes[0]), torch.from_numpy(valid[0]),
                                       (H, W))
    assert got.valid.sum() > 5
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(dets, k)),
                                      err_msg=k)
    v = got.valid.numpy()
    for k in ("scores", "boxes"):
        assert rel_err(getattr(got, k).numpy()[v], np.asarray(getattr(dets, k))[v]) < 1e-6, k


# ---------------------------------------------------------------- relation

REL = dict(feat_dim=64, groups=16, emb_dim=64)


def _rel_inputs(seed, n=6, m=10, k=5, s=2, k2=7):
    rng = np.random.RandomState(seed)

    def boxes(c):
        xy = rng.uniform(0, 80, (c, 2))
        return np.concatenate([xy, xy + rng.uniform(2, 40, (c, 2))], 1).astype(np.float32)

    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    ref_valid = rng.uniform(0, 1, m) > 0.2
    return dict(feat=f(n, 64), ref_feat=f(m, 64), boxes=boxes(n), ref_boxes=boxes(m),
                ref_valid=ref_valid, extra_kv=f(k, 64), extra_valid=np.arange(k) < 3,
                stage_kv=f(s, k2, 64), stage_valid=np.arange(k2)[None] < np.array([[4], [7]]))


@pytest.mark.parametrize("mode", ["rdn", "rdn_advanced", "joint_memory", "joint_stage_rings"])
def test_relation_stack_matches(mode):
    inputs = _rel_inputs(1)
    kw = dict(num_stages=2, **REL)
    call = dict(feat=inputs["feat"], ref_feat=inputs["ref_feat"], boxes=inputs["boxes"],
                ref_boxes=inputs["ref_boxes"], ref_valid=inputs["ref_valid"])
    if mode == "rdn_advanced":
        kw.update(advanced_stages=2, advanced_num=2, group_size=5)
    if mode.startswith("joint"):
        kw.update(joint=True)
        call.update(extra_kv=inputs["extra_kv"], extra_valid=inputs["extra_valid"])
    if mode == "joint_stage_rings":
        call.update(stage_kv=inputs["stage_kv"], stage_valid=inputs["stage_valid"],
                    return_stage_refs=True)
    jstack = jax_relation.RelationStack(**kw)
    arrays = {k: v for k, v in call.items() if k != "return_stage_refs"}
    flags = {k: v for k, v in call.items() if k == "return_stage_refs"}
    params = conditioned(jax.jit(lambda r: jstack.init(r, **arrays, **flags))(
        jax.random.PRNGKey(0))["params"])
    want = jax.jit(lambda p, a: jstack.apply({"params": p}, **a, **flags))(params, arrays)
    stack = relation.RelationStack(**kw)
    stack.load_state_dict({k[len("relation."):]: v for k, v in state_dict_from_jax(
        {"relation": params}).items()}, strict=True)
    with torch.no_grad():
        got = stack(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}, **flags)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) < RTOL
        assert np.abs(np.asarray(w)).max() > 1e-2


def test_position_embedding_matches():
    inputs = _rel_inputs(2)
    want = jax_relation.position_embedding(jax_relation.position_matrix(
        jnp.asarray(inputs["boxes"]), jnp.asarray(inputs["ref_boxes"])))
    got = relation.position_embedding(relation.position_matrix(
        torch.from_numpy(inputs["boxes"]), torch.from_numpy(inputs["ref_boxes"])))
    # sin/cos of arguments up to about 500, where fp32's spacing is 3e-5
    assert rel_err(got.numpy(), want) < RTOL


# ---------------------------------------------------------------- architectures

_JITTED = {}


def _jax_apply(kind, params, *args, method=None, capture=False, **kw):
    """The JAX model of ``kind`` applied under one cached ``jax.jit`` a
    (kind, method, capture, keywords)."""
    key = (kind, method, capture, tuple(sorted(kw)))
    if key not in _JITTED:
        model = JAX_MODELS[kind]()

        def run(p, *a, **k):
            if not capture:
                return model.apply({"params": p}, *a, **k, method=method)
            return model.apply({"params": p}, *a, **k, method=method,
                               mutable=["intermediates"],
                               capture_intermediates=lambda m, n: m.name == "predictor"
                               and m.parent is not None and m.parent.name is None)

        _JITTED[key] = jax.jit(run, static_argnames=("return_state",))
    return _JITTED[key](params, *args, **kw)


def _port_predictor_out(model):
    """A hook keeping the port model's last predictor output."""
    keep = {}
    model.predictor.register_forward_hook(lambda m, i, o: keep.__setitem__("out", o) and None)
    return keep


def _dets_agree(got, want, logits_got, logits_want, what, rtol=RTOL):
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=f"{what}: {k}")
    assert int(got.valid.sum()) > 0, f"{what}: no detection"
    for g, w in zip(logits_got, logits_want):
        assert rel_err(g.numpy(), w) < rtol, f"{what}: predictor outputs"
    v = got.valid.numpy()   # after the selections: the predictions' 1e-3
    assert rel_err(got.scores.numpy()[v], np.asarray(want.scores)[v]) < 1e-3, what
    assert rel_err(got.boxes.numpy()[v], np.asarray(want.boxes)[v]) < 1e-3, what


@pytest.mark.parametrize("kind", ["base", "rdn", "rdn_adv"])
def test_single_window_archs_match(rcnn_params, kind):
    params = rcnn_params[kind]
    cur, refs = _images(10, 1), _images(11, 3)
    args = (cur,) if kind == "base" else (cur, refs)
    want, inter = _jax_apply(kind, params, *args, (H, W), capture=True)
    model = port_of(kind, params)
    keep = _port_predictor_out(model)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args), (H, W))
    jl = inter["intermediates"]["predictor"]["__call__"][0]
    _dets_agree(got, want, keep["out"], jl, kind)


@pytest.mark.parametrize("kind", ["mega3", "mega3_mem", "mega0"])
def test_mega_matches_with_its_memories(rcnn_params, kind):
    """Memory from 3 global frames (a chunk of 2, then 1), then 3 frames in
    a row with the same state threaded (the stage rings wrap at 150)."""
    params = rcnn_params[PARAMS_OF.get(kind, kind)]
    jmodel = JAX_MODELS[kind]()
    model = port_of(kind, params)
    g = _images(20, 3)
    jstate, state = jmodel.init_state(), model.init_state()
    for s in (0, 2):
        jf, jv = _jax_apply(kind, params, g[s:s + 2], (H, W), method=JaxMEGA.memory_features)
        jstate = jmodel.apply({"params": params}, jstate, jf, jv, method=JaxMEGA.update_memory)
        with torch.no_grad():
            f, v = model.memory_features(torch.from_numpy(g[s:s + 2]), (H, W))
        assert rel_err(f.numpy(), jf) < RTOL
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        state = model.update_memory(state, f, v)
    assert state.mem.count == int(jstate.mem.count) == 8       # FPS thinned 12 or 75 rows
    assert rel_err(state.mem.feats.numpy(), jstate.mem.feats) < RTOL
    keep = _port_predictor_out(model)
    for t in range(3):
        cur, refs = _images(30 + t, 1), _images(40 + t, 3)
        if kind == "mega3_mem":
            (want, jstate), inter = _jax_apply(kind, params, cur, refs, (H, W), state=jstate,
                                               return_state=True, capture=True)
        else:
            want, inter = _jax_apply(kind, params, cur, refs, (H, W), state=jstate,
                                     capture=True)
        with torch.no_grad():
            got = model(torch.from_numpy(cur), torch.from_numpy(refs), (H, W), state=state,
                        return_state=kind == "mega3_mem")
        if kind == "mega3_mem":
            got, state = got
            assert list(state.stage_count) == np.asarray(jstate.stage_count).tolist()
            # the stage-refined reference rows are the sensitive ones: fed
            # the same inputs, the two RelationStacks differ by about 3e-5
            # there (1.7e-6 in the current rows), and the trunk's 1e-6 adds
            assert rel_err(state.stage_feats.numpy(), jstate.stage_feats) < 1e-3
        _dets_agree(got, want, keep["out"], inter["intermediates"]["predictor"]["__call__"][0],
                    f"{kind} frame {t}", MEGA_RTOL)
    if kind == "mega3_mem":
        assert state.stage_count == (225, 225, 225)


@pytest.fixture(scope="module")
def dafa_params():
    return jax_dafa_params()


def test_dafa_matches(dafa_params):
    """DAFA-G (two aggregation stages): extract_topk on 2 global frames,
    the memory update (FPS over 16 slots), then every stage's logits and
    boxes."""
    params = dafa_params
    jmodel = JaxDAFA(**DAFA, res_stage=2)
    model = port_of("dafa", params)
    whwh = np.asarray([W, H, W, H], np.float32)
    g, cur = _images(50, 3), _images(51, 1)
    jf = jax.jit(lambda p, x, w: jmodel.apply({"params": p}, x, w,
                                              method=JaxDAFA.extract_topk))(params, g, whwh)
    jstate = jmodel.apply({"params": params}, jmodel.init_state(), jf,
                          method=JaxDAFA.update_memory)
    jl, jb = jax.jit(lambda p, x, w, s: jmodel.apply({"params": p}, x, w, state=s))(
        params, cur, whwh, jstate)
    with torch.no_grad():
        f = model.extract_topk(torch.from_numpy(g), torch.from_numpy(whwh))
        state = model.update_memory(model.init_state(), f)
        lg, bx = model(torch.from_numpy(cur), torch.from_numpy(whwh), state=state)
    assert rel_err(f.numpy(), jf) < RTOL
    assert state.mem.count == int(jstate.mem.count) == 16
    assert rel_err(state.mem.feats.numpy(), jstate.mem.feats) < RTOL
    assert lg.shape == (6, 1, 16, CLASSES) and bx.shape == (6, 1, 16, 4)
    assert rel_err(lg.numpy(), jl) < RTOL and rel_err(bx.numpy(), jb) < RTOL


@pytest.mark.parametrize("cond", [False, True], ids=["dafa_stage", "with_shift"])
def test_time_free_stage_matches(cond):
    """``RCNNHead(use_time=False)``: DAFA's stage, and with the optional
    ``c_mlp(cond)`` shift, on 3 levels of maps (the plain K1/K2 versions)."""
    from diffusionvid_tpu.models.heads import RCNNHead as JaxHead
    from diffusionvid_torch.models.heads import RCNNHead
    from diffusionvid_torch.utils.convert import _flatten, _rcnn_head_name
    rng = np.random.RandomState(4)
    feats = [rng.randn(1, 16 // s, 24 // s, 256).astype(np.float32) for s in (1, 2, 4)]
    scales = (1 / 8, 1 / 16, 1 / 32)
    xy = rng.uniform(0, 120, (1, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (1, 5, 2))], -1).astype(np.float32)
    pro = rng.randn(1, 5, 256).astype(np.float32)
    c = rng.randn(1, 5, 256).astype(np.float32) if cond else None
    head = JaxHead(num_classes=CLASSES, use_time=False)
    run = lambda p, f, b, x, cc: head.apply({"params": p}, f, scales, b, x, None, cc)  # noqa: E731
    params = conditioned(jax.jit(lambda r: head.init(r, feats, scales, boxes, pro, None, c))(
        jax.random.PRNGKey(1))["params"])
    want = jax.jit(run)(params, feats, boxes, pro, c)
    port = RCNNHead(num_classes=CLASSES, use_time=False, conditioned=cond)
    port.load_state_dict({_rcnn_head_name(path): torch.from_numpy(np.array(v))
                          for path, v in _flatten(params)}, strict=True)
    assert not hasattr(port, "block_time_mlp") and hasattr(port, "c_mlp") == cond
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats], scales, torch.from_numpy(boxes),
                   torch.from_numpy(pro), None, None if c is None else torch.from_numpy(c))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < RTOL


def test_strict_names(rcnn_params, dafa_params):
    """The port's names of each tree: the trunk's detectron2 names, the
    rest the JAX package's paths."""
    names = set(port_of("rdn_adv", rcnn_params["rdn_adv"]).state_dict())
    for n in ("detector.backbone.bottom_up.stem.conv1.weight",
              "detector.backbone.bottom_up.res4.1.conv2.norm.running_var",
              "detector.rpn.cls_logits.bias", "detector.roi_head.head.res5.0.shortcut.weight",
              "detector.roi_head.head.res5.1.conv3.norm.bias", "reduce.weight",
              "relation.fc2.weight", "relation.attn3.Wg_weight", "relation.attn0.Wq.weight",
              "relation.attn1.Wv_bias", "predictor.cls_score.weight"):
        assert n in names, n
    assert not any(n.startswith("detector.predictor") for n in names)
    assert "global_lm.Wv_weight" in port_of("mega0", rcnn_params["mega0"]).state_dict()
    names = set(port_of("dafa", dafa_params).state_dict())
    for n in ("backbone.bottom_up.res5.0.shortcut.norm.weight", "backbone.fpn_output4.bias",
              "heads.5.inst_interact.dynamic_layer.weight", "heads.0.class_logits.bias",
              "temporal_attn.in_proj_weight", "init_proposal_boxes", "init_proposal_features"):
        assert n in names, n
    assert not any("block_time_mlp" in n or "c_mlp" in n for n in names)


# ---------------------------------------------------------------- builder and refusals

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
C4_CONFIGS = {"base": "configs/vid_R_101_C4_1x.yaml",
              "rdn": "configs/RDN/vid_R_101_C4_RDN_base_1x.yaml",
              "mega": "configs/MEGA/vid_R_101_C4_MEGA_1x.yaml",
              "dafa": "configs/MEGA/vid_R_101_C4_DAFA_1x.yaml"}
TINY = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32"]


@pytest.mark.parametrize("method", sorted(C4_CONFIGS))
def test_builder_reads_the_config(method):
    from diffusionvid_tpu.config import load_config as jax_load_config
    from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
    cfg = load_config(str(ROOT / C4_CONFIGS[method]), TINY)
    model = build_detection_model(cfg, device="cpu")
    ref = jax_build(jax_load_config(str(ROOT / C4_CONFIGS[method]), TINY))
    assert model.compute_dtype == torch.float32
    if method == "dafa":
        assert (model.num_proposals, model.memory_size, model.res_stage, model.num_classes) == (
            ref.num_proposals, ref.memory_size, ref.res_stage, ref.num_classes) == (
            300, 900, 1, 30)
        return
    det = model if method == "base" else model.detector
    assert (det.pre_nms_test, det.post_nms_test, det.ref_post_nms) == (6000, 300, 75)
    assert det.roi_head.head.res5[0].conv2.dilation == 2          # RES5_DILATION 2
    if method != "base":
        assert model.relation_stages == ref.relation_stages
        assert len([m for m in model.relation.children()]) == 2 * ref.relation_stages
    if method == "mega":
        assert (model.memory_size, model.use_stage_mem, model.stage_mem_cap) == (
            ref.memory_size, ref.use_stage_mem, ref.stage_mem_cap) == (750, True, 1875)


@pytest.mark.parametrize("opts, item", [
    (["MODEL.MASK_ON", "True"], "MEGAArch"),
    (["MODEL.KEYPOINT_ON", "True"], "MEGAArch"),
    (["MODEL.RETINANET_ON", "True"], "RetinaNet"),
], ids=["mask", "keypoint", "retinanet"])
def test_unported_parts_raise_naming_their_item(opts, item):
    """The three flags on the MEGA config, refused (ROADMAP.md A8) until the
    still-image slice: now built as the JAX ``build_detection_model`` builds them.  MEGA
    ignores the mask and keypoint flags (the heads reach ``base`` alone):
    the same tensors as without; ``RETINANET_ON`` builds RetinaNet whatever
    the method, its classes and anchors from ``MODEL.RETINANET``."""
    from diffusionvid_tpu.config import load_config as jax_load_config
    from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
    path = str(ROOT / C4_CONFIGS["mega"])
    ref = jax_build(jax_load_config(path, TINY + opts))
    model = build_detection_model(load_config(path, TINY + opts), device="cpu")
    assert type(model).__name__ == type(ref).__name__ == item
    if item == "RetinaNet":
        assert (model.num_classes, model.anchor_sizes, model.strides, model.detections,
                model.pre_nms_top_n) == (ref.num_classes, tuple(ref.anchor_sizes),
                                         tuple(ref.strides), ref.detections,
                                         ref.pre_nms_top_n) == (81, (32, 64, 128, 256, 512),
                                                                (8, 16, 32, 64, 128), 100, 1000)
        return
    assert ref == jax_build(jax_load_config(path, TINY))
    plain = build_detection_model(load_config(path, TINY), device="cpu")
    assert model.state_dict().keys() == plain.state_dict().keys()


# the MEGA config with each option, and what both builders make of it: the
# class, then attributes that the option sets
PORTED = {
    "dff": (["MODEL.VID.METHOD", "dff"], "DFFArch", ("key_frame_duration",)),
    "fgfa": (["MODEL.VID.METHOD", "fgfa"], "FGFAArch", ()),
    "global_pixel": (["MODEL.VID.MEGA.GLOBAL.PIXEL_ATTEND", "True"], "MEGAArch",
                     ("pixel_attend_global", "pixel_replaces_box", "pixel_mem_size",
                      "relation_stages")),
    "local_pixel": (["MODEL.VID.MEGA.LOCAL.PIXEL_ATTEND", "True",
                     "MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "False"], "MEGAArch",
                    ("pixel_attend_local", "pixel_replaces_box", "relation_stages")),
    "resnext": (["MODEL.RESNETS.NUM_GROUPS", "32", "MODEL.RESNETS.WIDTH_PER_GROUP", "4"],
                "MEGAArch", ("relation_stages",)),
    "bbox_aug": (["TEST.BBOX_AUG.ENABLED", "True"], "MEGAArch", ("memory_size",)),
}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_parts_build_as_jax(name):
    """Each option builds the JAX package's architecture: the same class
    and attributes; ResNeXt's grouped 3x3s (32 groups of 4: res2's
    bottleneck 128 wide, res5's 1,024) in the trunk and the res5 head;
    ``TEST.BBOX_AUG`` is the engine's, which refuses it off ``base``."""
    from diffusionvid_tpu.config import load_config as jax_load_config
    from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
    opts, cls, attrs = PORTED[name]
    path = str(ROOT / C4_CONFIGS["mega"])
    model = build_detection_model(load_config(path, TINY + opts), device="cpu")
    ref = jax_build(jax_load_config(path, TINY + opts))
    assert type(model).__name__ == type(ref).__name__ == cls
    for a in attrs:
        assert getattr(model, a) == getattr(ref, a), a
    det = model.detector
    groups, width = (32, 4) if name == "resnext" else (1, 64)
    assert det.backbone.bottom_up.res2[0].conv2.groups == groups
    assert det.roi_head.head.res5[0].conv2.groups == groups
    assert (ref.num_groups, ref.width_per_group) == (groups, width)
    if name == "resnext":
        assert det.backbone.bottom_up.res2[0].conv2.weight.shape == (128, 4, 3, 3)
        assert det.roi_head.head.res5[0].conv2.weight.shape == (1024, 32, 3, 3)
    assert hasattr(model, "pixel_attn") == ("pixel" in name)


def test_run_inference_video_arch_refuses():
    from diffusionvid_torch.engine.inference_mega import run_inference_video_arch
    for method in ("fgfa", "mega"):
        with pytest.raises(ValueError, match="TEST.BBOX_AUG is only implemented for METHOD "
                                             "'base'"):
            run_inference_video_arch(None, None, None, method=method, use_bbox_aug=True)
    with pytest.raises(ValueError, match="unknown VID.METHOD"):
        run_inference_video_arch(None, None, None, method="selsa")
    with pytest.raises(ValueError, match="SHUFFLED_CUR_TEST"):
        run_inference_video_arch(None, None, None, method="rdn", shuffled_cur=True)
