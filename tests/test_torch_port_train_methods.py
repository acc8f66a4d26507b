"""The MEGA family's train losses in the port against the JAX package: units.

``encode_boxes`` (a round trip through ``decode_boxes``, JAX's values to
1e-6), ``match_anchors`` (labels and matches equal: the low-quality
recovery, invalid GT slots, no GT), ``sample_balanced`` on the JAX
package's keys (equal masks, also with no positive and with more positives
than the batch takes), ``rpn_loss`` and ``fast_rcnn_loss`` on its keys
(within 1e-5 relative, the invalid-proposal labels, the class-specific
deltas), and the parameter groups of the six methods' trees against the
JAX package's ``_param_label``.

The JAX package draws the samplers' uniforms inside ``vmap`` from keys it
splits (``rpn_loss`` / ``fast_rcnn_loss``: one key an image, split in two
for the positives and the negatives); ``jax_uniforms`` draws the same
uniforms from the key those functions take, and the port's losses take
them as their ``keys``.  ``JaxKeys`` captures the keys that a JAX model's
train forward passes to the two losses (the names patched in the modules
that call them), for the whole-method tests in
``test_torch_port_train_methods_c4.py`` and ``_mega.py``.

Those run one sample of each method at depth 18 on 64x96 frames through
``engine/train_methods.method_sample_loss`` against one ``jit`` of the JAX
package's ``value_and_grad`` on the same weights and draws: the losses
within 1e-4 relative under the same names, every gradient within 1e-3 of
its norm.  The weights are the port's random ones, conditioned
(``chip_smoke.conditioned_method_model``) so that the comparison is
well-posed in float32: no ReLU input near its kink, and no two boxes of
the relation's position embedding a fraction of a pixel apart (it
multiplies the two sides' box differences by 100 over such a distance, and
two frames' proposals are often that close: the conditioning's proposals
are anchors clipped to the image, the same on both sides to the last bit).
For the same reason RDN's and MEGA's current slots are all GT
(``post_nms_train`` = G): in the JAX package a current proposal and its
duplicate among the current frame's reference proposals come from two RPN
passes (one frame, then the batch of frames), which its XLA convolutions
do not make bit-equal, so their offset is 1e-6 px and not 0, and the
gradient of ``log(|dx| / w + 1e-3)`` there is noise of size 1/(1e-3 w)
(ROADMAP.md §C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.engine import train as jt
from diffusionvid_tpu.models import box_head as jax_box_head
from diffusionvid_tpu.models import rcnn as jax_rcnn
from diffusionvid_tpu.models import rpn as jax_rpn
from diffusionvid_tpu.models import video_archs as jax_video_archs
from diffusionvid_tpu.models.dafa import SparseRCNNDAFA as JaxDAFA
from diffusionvid_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from diffusionvid_tpu.models.video_archs import DFFArch as JaxDFF
from diffusionvid_tpu.models.video_archs import FGFAArch as JaxFGFA
from diffusionvid_tpu.models.video_archs import MEGAArch as JaxMEGA
from diffusionvid_tpu.models.video_archs import RDNArch as JaxRDN
from diffusionvid_tpu.structures import boxes as jax_boxes

from diffusionvid_torch.data.sampling import MethodSampleSpec
from diffusionvid_torch.engine import train as tt
from diffusionvid_torch.engine.train_methods import method_sample_loss, uniform_draw
from diffusionvid_torch.models import box_head, rpn
from diffusionvid_torch.models.dafa import SparseRCNNDAFA
from diffusionvid_torch.models.rcnn import GeneralizedRCNN
from diffusionvid_torch.models.video_archs import DFFArch, FGFAArch, MEGAArch, RDNArch
from diffusionvid_torch.structures.boxes import decode_boxes, encode_boxes
from diffusionvid_torch.utils.convert import _torch_name, state_dict_from_jax
from chip_smoke import conditioned_method_model
from test_torch_port_weights import one_thread, rel_err  # noqa: F401

H, W, K, G = 64, 96, 5, 6


def jax_uniforms(rng, b: int, n: int) -> np.ndarray:
    """``[b, 2, n]``: the uniforms that ``rpn_loss`` / ``fast_rcnn_loss``
    draw from ``rng`` for ``sample_balanced`` (one key an image, split into
    the positives' and the negatives' key)."""
    out = []
    for key in jax.random.split(rng, b):
        r1, r2 = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(r1, (n,))),
                    np.asarray(jax.random.uniform(r2, (n,)))])
    return np.asarray(out, np.float32)


class JaxKeys:
    """Patches ``rpn_loss`` and ``fast_rcnn_loss`` where the JAX models
    call them, recording (by ``jax.debug.callback``, so under ``jit`` too)
    each call's key and sizes; ``draw`` hands the uniforms of those keys to
    the port's model in its order of calls: the RPN's, then the head's."""

    def __init__(self, monkeypatch):
        self.calls = {"rpn": [], "head": []}

        def recording(fn, kind, size):
            def call(rng, *args, **kw):
                b, n = size(*args)
                jax.debug.callback(lambda k: self.calls[kind].append((np.asarray(k), b, n)),
                                   rng)
                return fn(rng, *args, **kw)
            return call

        rpn_size = lambda logits, deltas, anchors, *rest: (logits.shape[0], anchors.shape[0])  # noqa: E731
        head_size = lambda logits, deltas, props, *rest: (logits.shape[0], props.shape[1])  # noqa: E731
        for mod in (jax_rcnn, jax_video_archs):
            monkeypatch.setattr(mod, "rpn_loss", recording(jax_rpn.rpn_loss, "rpn", rpn_size))
            monkeypatch.setattr(mod, "fast_rcnn_loss", recording(jax_box_head.fast_rcnn_loss,
                                                                 "head", head_size))

    @property
    def uniforms(self) -> list:
        return [jax_uniforms(*self.calls[kind][0]) for kind in ("rpn", "head")
                if self.calls[kind]]

    def draw(self):
        pending = self.uniforms

        def take(shape):
            u = pending.pop(0)
            assert u.shape == tuple(shape), (u.shape, shape)
            return torch.from_numpy(u)
        return take


def _boxes(rng, n, lo=6, hi=50):
    xy = rng.uniform(0, 60, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(lo, hi, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("plus_one", [True, False])
def test_encode_boxes_round_trip_and_matches_jax(plus_one):
    rng = np.random.RandomState(0)
    props, gt = _boxes(rng, 50), _boxes(rng, 50)
    want = np.asarray(jax_boxes.encode_boxes(jnp.asarray(gt), jnp.asarray(props),
                                             plus_one=plus_one))
    got = encode_boxes(torch.from_numpy(gt), torch.from_numpy(props), plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = decode_boxes(got, torch.from_numpy(props), plus_one=plus_one)
    np.testing.assert_allclose(back.numpy(), gt, rtol=0, atol=1e-4)


def _anchor_case(case: str):
    rng = np.random.RandomState(1)
    anchors = rpn.shift_anchors(rpn.generate_anchors(), 4, 6, 16)
    gt = _boxes(rng, G, 10, 60)
    valid = np.array([True, True, False, True, False, False])
    gt[3] = anchors[12 * 6 * 2 + 4] + [6, 0, 6, 0]   # a 64x64 anchor moved by 6: IoU 0.83
    if case == "low_quality":      # a tiny GT: no anchor reaches 0.7, its best still is fg
        gt[0] = [30, 30, 34, 33]
    if case == "no_gt":
        valid[:] = False
    return anchors, gt, valid


@pytest.mark.parametrize("case", ["spread", "low_quality", "no_gt"])
def test_match_anchors_matches_jax(case):
    anchors, gt, valid = _anchor_case(case)
    want_m, want_l = jax.jit(jax_rpn.match_anchors)(anchors, gt, valid)
    got_m, got_l = rpn.match_anchors(*(torch.from_numpy(a) for a in (anchors, gt, valid)))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    fg = got_l.numpy() == 1
    np.testing.assert_array_equal(got_m.numpy()[fg], np.asarray(want_m)[fg])
    if case == "low_quality":
        iou = np.asarray(jax_boxes.pairwise_iou(anchors, gt, plus_one=True))[:, 0]
        assert iou.max() < 0.7 and fg[iou == iou.max()].all()
    if case == "no_gt":
        assert not fg.any() and (got_l.numpy() == 0).all()
    else:
        assert fg.any() and (got_l.numpy() == -1).any()


@pytest.mark.parametrize("n_pos, n_neg, batch", [(30, 200, 64), (0, 100, 64), (90, 20, 64),
                                                 (5, 7, 256)],
                         ids=["both_cut", "no_positive", "positives_cut", "all_taken"])
def test_sample_balanced_on_jax_keys(n_pos, n_neg, batch):
    rng = np.random.RandomState(n_pos + n_neg)
    labels = np.full(n_pos + n_neg + 40, -1, np.int32)
    labels[:n_pos], labels[n_pos:n_pos + n_neg] = 1, 0
    labels = labels[rng.permutation(len(labels))]
    key = jax.random.PRNGKey(n_pos)
    want_p, want_n = jax.jit(jax_rpn.sample_balanced, static_argnums=(2,))(key, labels, batch)
    # sample_balanced splits the key it takes: hand it that key's draws
    r1, r2 = jax.random.split(key)
    keys = np.stack([np.asarray(jax.random.uniform(r1, (len(labels),))),
                     np.asarray(jax.random.uniform(r2, (len(labels),)))])
    got_p, got_n = rpn.sample_balanced(torch.from_numpy(keys), torch.from_numpy(labels), batch)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_p.sum() == min(n_pos, batch // 2)
    assert got_n.sum() == min(n_neg, batch - int(got_p.sum()))


def test_rpn_loss_on_jax_keys():
    anchors, gt, valid = _anchor_case("spread")
    rng = np.random.RandomState(2)
    b, a = 2, 12
    logits = rng.randn(b, 4, 6, a).astype(np.float32)
    deltas = (0.3 * rng.randn(b, 4, 6, 4 * a)).astype(np.float32)
    gts = np.stack([gt, _boxes(rng, G, 10, 60)])
    valids = np.stack([valid, np.arange(G) < 4])
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda *x: jax_rpn.rpn_loss(key, *x, batch_size=64))(
        logits, deltas, anchors, gts, valids)
    got = rpn.rpn_loss(torch.from_numpy(jax_uniforms(key, b, len(anchors))),
                       *(torch.from_numpy(x) for x in (logits, deltas, anchors, gts, valids)),
                       batch_size=64)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) < 1e-5, k
        assert float(want[k]) > 0


def test_fast_rcnn_loss_on_jax_keys():
    rng = np.random.RandomState(3)
    b, r = 2, 40
    gts = np.stack([_boxes(rng, G, 10, 60) for _ in range(b)])
    gt_labels = rng.randint(1, K + 1, (b, G)).astype(np.int32)
    gt_valid = np.stack([np.arange(G) < 4, np.arange(G) < 2])
    # proposals: jittered GT (foreground), random boxes; some invalid
    jit = gts[:, rng.randint(0, 2, r // 2)] + rng.uniform(-3, 3, (b, r // 2, 4))
    props = np.concatenate([jit, np.stack([_boxes(rng, r // 2) for _ in range(b)])],
                           1).astype(np.float32)
    pv = rng.uniform(size=(b, r)) > 0.15
    logits = rng.randn(b, r, K + 1).astype(np.float32)
    deltas = (0.5 * rng.randn(b, r, 4 * (K + 1))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    args = (logits, deltas, props, pv, gts, gt_labels, gt_valid)
    want = jax.jit(lambda *x: jax_box_head.fast_rcnn_loss(key, *x, batch_size=24))(*args)
    got = box_head.fast_rcnn_loss(torch.from_numpy(jax_uniforms(key, b, r)),
                                  *(torch.from_numpy(x) for x in args), batch_size=24)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) < 1e-5, k
        assert float(want[k]) > 0


def test_fast_rcnn_loss_of_a_zero_width_proposal_is_finite():
    """A proposal of zero width (x2 = x1 - 1: an RPN ``dw`` that underflows)
    among the negatives encodes to inf against its GT; its box loss is
    masked out.  XLA folds the JAX package's ``reg * pos_sel`` into a
    select, so JAX's loss is finite; PyTorch keeps IEEE's 0 * inf = NaN, so
    the port masks the targets instead (ROADMAP.md §C).  Both agree."""
    rng = np.random.RandomState(4)
    gts = _boxes(rng, G, 10, 60)[None]
    gt_labels = rng.randint(1, K + 1, (1, G)).astype(np.int32)
    gt_valid = (np.arange(G) < 3)[None]
    props = np.concatenate([gts[:, :3] + 1.0, _boxes(rng, 5)[None]], 1).astype(np.float32)
    props[0, 7] = [300.0, 300.0, 299.0, 330.0]     # width 0, far from every GT
    pv = np.ones((1, 8), bool)
    logits = rng.randn(1, 8, K + 1).astype(np.float32)
    deltas = (0.5 * rng.randn(1, 8, 4 * (K + 1))).astype(np.float32)
    key = jax.random.PRNGKey(2)
    args = (logits, deltas, props, pv, gts, gt_labels, gt_valid)
    want = jax.jit(lambda *x: jax_box_head.fast_rcnn_loss(key, *x))(*args)
    got = box_head.fast_rcnn_loss(torch.from_numpy(jax_uniforms(key, 1, 8)),
                                  *(torch.from_numpy(x) for x in args))
    for k in want:
        assert np.isfinite(float(got[k])) and rel_err(got[k].numpy(), want[k]) < 1e-5, k
    assert float(got["loss_box_reg"]) > 0


# ---------------------------------------------------------------- the methods' trees

SMALL = dict(pre_nms=100, post_nms=8, pre_nms_train=100, post_nms_train=24)
# RDN's and MEGA's current slots all GT: see the module's docstring
GT_SLOTS = dict(SMALL, post_nms_train=G)
ARCH = dict(depth=18, num_classes=K + 1)   # with the background
DAFA = dict(depth=18, num_classes=K, num_proposals=16, num_stages=3, top_k=8, memory_size=64,
            res_stage=2)
# (port model, JAX model, JAX train method name, frames: locals, mems, globals)
METHODS = {
    "base": (lambda: GeneralizedRCNN(**ARCH, pre_nms_test=100, post_nms_test=8,
                                     pre_nms_train=100, post_nms_train=24, ref_post_nms=4),
             lambda: JaxRCNN(**ARCH, pre_nms_test=100, post_nms_test=8, pre_nms_train=100,
                             post_nms_train=24, ref_post_nms=4),
             None, (0, 0, 0)),
    "dff": (lambda: DFFArch(**ARCH, **SMALL), lambda: JaxDFF(**ARCH, **SMALL), "train_loss",
            (1, 0, 0)),
    "fgfa": (lambda: FGFAArch(**ARCH, **SMALL), lambda: JaxFGFA(**ARCH, **SMALL),
             "train_loss", (2, 0, 0)),
    "rdn": (lambda: RDNArch(**ARCH, **GT_SLOTS, relation_stages=2, ref_post_nms=4),
            lambda: JaxRDN(**ARCH, **GT_SLOTS, relation_stages=2, ref_post_nms=4),
            "train_loss", (2, 0, 0)),
    "rdn_advanced": (lambda: RDNArch(**ARCH, **GT_SLOTS, relation_stages=2, advanced_stages=1,
                                     advanced_num=2, ref_post_nms=4),
                     lambda: JaxRDN(**ARCH, **GT_SLOTS, relation_stages=2, advanced_stages=1,
                                    advanced_num=2, ref_post_nms=4),
                     "train_loss", (2, 0, 0)),
    "mega": (lambda: MEGAArch(**ARCH, **GT_SLOTS, relation_stages=3, ref_post_nms=4,
                              memory_size=16),
             lambda: JaxMEGA(**ARCH, **GT_SLOTS, relation_stages=3, ref_post_nms=4,
                             memory_size=16),
             "train_loss_mega", (2, 1, 1)),
    # LOCAL.PIXEL_ATTEND without relation stages: the pixel path replaces
    # the box relation; 1 + 4 frames hold the 100 irrelevant pixels at 4x6
    "mega_pixel": (lambda: MEGAArch(**ARCH, **SMALL, relation_stages=0, ref_post_nms=4,
                                    memory_size=16, pixel_attend_local=True),
                   lambda: JaxMEGA(**ARCH, **SMALL, relation_stages=0, ref_post_nms=4,
                                   memory_size=16, pixel_attend_local=True),
                   "train_loss_mega", (4, 0, 1)),
    "dafa": (lambda: SparseRCNNDAFA(**DAFA), lambda: JaxDAFA(**DAFA), "train_loss",
             (0, 0, 2)),
}


def method_inputs(name: str, seed: int = 0):
    """One sample of ``name``'s layout, as numpy: images ``[B, H, W, 3]``,
    GT ``[B, G]`` (a few valid slots, labels 1..K, the current frame's
    boxes moving a little across the frames), whwh."""
    loc, mem, glo = METHODS[name][3]
    b = 1 + loc + mem + glo
    rng = np.random.RandomState(seed)
    base = _boxes(rng, G, 12, 50)
    boxes = np.stack([base + rng.uniform(-2, 2, base.shape) for _ in range(b)]).astype(np.float32)
    valid = np.zeros((b, G), bool)
    valid[:, :4] = True
    labels = np.tile(rng.randint(1, K + 1, G), (b, 1)).astype(np.int32)
    return (rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), boxes, labels, valid,
            np.asarray([W, H, W, H], np.float32))


def jax_train_args(name: str, arrays):
    """The JAX train method's positional arguments for one sample (the
    slicing of ``engine/train_methods.py``)."""
    images, boxes, labels, valid, whwh = (jnp.asarray(a) for a in arrays)
    loc, mem, glo = METHODS[name][3]
    hw = (float(whwh[1]), float(whwh[0]))
    cur, first = images[:1], (boxes[:1], labels[:1], valid[:1])
    if name == "base":
        return (cur, hw, *first)
    if name in ("dff", "fgfa"):
        return (cur, images[1:1 + loc], hw, *first)
    if name.startswith("rdn"):
        return (cur, images[1:1 + loc], hw, boxes[0], labels[0], valid[0])
    if name.startswith("mega"):
        return (cur, images[1:1 + loc], images[1 + loc:1 + loc + mem],
                images[1 + loc + mem:], hw, boxes[0], labels[0], valid[0])
    return (cur, images[1 + loc + mem:], whwh, *first)


def jax_apply(name: str, jmodel, params, args, rngs):
    method = METHODS[name][2]
    if method is None:
        return jmodel.apply({"params": params}, *args, train=True, rngs=rngs)
    return jmodel.apply({"params": params}, *args, method=getattr(type(jmodel), method),
                        rngs=rngs)


def jax_tree_like(name: str, jmodel, arrays, state: dict):
    """The JAX parameter tree of ``name``'s train forward (its shapes from
    ``jax.eval_shape`` of the init), filled from the port's ``state``."""
    args = jax_train_args(name, arrays)
    method = METHODS[name][2]
    rngs = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}
    if method is None:
        shapes = jax.eval_shape(lambda: jmodel.init(rngs, *args, train=True))["params"]
    else:
        shapes = jax.eval_shape(lambda: jmodel.init(rngs, *args,
                                                    method=getattr(type(jmodel), method)))
        shapes = shapes["params"]

    def fill(path, leaf):
        v = state[_torch_name(tuple(p.key for p in path), (3, 4, 5))]
        assert tuple(v.shape) == tuple(leaf.shape), path
        return jnp.asarray(v.detach().numpy())

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", list(METHODS))
def test_param_groups_match_jax_labels(name):
    """Each method's tensors in the JAX package's ``_param_label`` groups:
    ``base``'s and DAFA's trunk is the backbone, the trunk of DFF, FGFA,
    RDN and MEGA (under ``detector``) is not; the FrozenBN statistics are
    frozen; the relation's ``Wg_bias`` / ``Wv_bias`` are weights."""
    model = METHODS[name][0]()
    tree = jax_tree_like(name, METHODS[name][1](), method_inputs(name), model.state_dict())
    labels = {}
    jax.tree_util.tree_map_with_path(
        lambda p, _: labels.__setitem__(_torch_name(tuple(k.key for k in p), (3, 4, 5)),
                                        jt._param_label(p)), tree)
    params = dict(model.named_parameters())
    assert set(labels) == set(params)
    for n in params:
        assert tt.param_group(n) == labels[n], n
    groups = {tt.param_group(n) for n in params}
    trunk_top = name in ("base", "dafa")
    assert ("backbone" in groups) == trunk_top and ("backbone_bias" in groups) == trunk_top
    assert {"main", "bias", "frozen"} <= groups


# ---------------------------------------------------------------- whole methods

SPECS = {
    "base": MethodSampleSpec("base"),
    "dff": MethodSampleSpec("dff", num_local=1, min_offset=-9, max_offset=0),
    "fgfa": MethodSampleSpec("fgfa", num_local=2, min_offset=-9, max_offset=9),
    "rdn": MethodSampleSpec("rdn", num_local=2, min_offset=-18, max_offset=18),
    "rdn_advanced": MethodSampleSpec("rdn", num_local=2, min_offset=-18, max_offset=18),
    "mega": MethodSampleSpec("mega", num_local=2, num_mem=1, num_global=1),
    "mega_pixel": MethodSampleSpec("mega", num_local=4, num_global=1),
    "dafa": MethodSampleSpec("dafa", num_global=2),
}
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3


def conditioned_port(name: str, seed: int = 0):
    """The port's float32 model of ``name`` with random weights from
    ``seed``, conditioned on its own train forward of ``method_inputs``
    (``chip_smoke.conditioned_method_model``)."""
    model = METHODS[name][0]()
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    sample = [torch.from_numpy(a) for a in method_inputs(name, seed)]
    run = lambda: method_sample_loss(model, SPECS[name], *sample,  # noqa: E731
                                     uniform_draw(seed, "cpu"))
    return conditioned_method_model(model, gen, run), sample


def port_step(model, name: str, sample, draw):
    """The port's loss of one sample through ``method_sample_loss`` and its
    gradients: (total, losses, {name: grad or None})."""
    model.zero_grad(set_to_none=True)
    total, losses = method_sample_loss(model, SPECS[name], *sample, draw)
    total.backward()
    return (total.detach(), {k: v.detach() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


def jax_step(name: str, model, sample, monkeypatch):
    """The JAX package's loss and gradients of the same sample on the port's
    weights (one ``jit`` of ``value_and_grad``; DAFA's total is
    ``total_loss_stages``), and its samplers' draws (``JaxKeys``)."""
    jmodel = METHODS[name][1]()
    arrays = [t.numpy() for t in sample]
    params = jax_tree_like(name, jmodel, arrays, model.state_dict())
    args = jax_train_args(name, arrays)
    keys = JaxKeys(monkeypatch)

    def loss(p):
        losses = jax_apply(name, jmodel, p, args, {"sampler": jax.random.PRNGKey(7)})
        total = losses.pop("total_loss_stages") if name == "dafa" else sum(losses.values())
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return total, losses, state_dict_from_jax(grads), keys


def grad_errors(got: dict, want: dict) -> dict:
    """|g - w| / |w| per tensor (a missing gradient counts as zero)."""
    out = {}
    for n, w in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(w)
        out[n] = float(torch.linalg.vector_norm(g - w)) / max(
            float(torch.linalg.vector_norm(w)), 1e-12)
    return out


_CHECKED = {}


def check_method_vs_jax(name: str, monkeypatch):
    """Losses within 1e-4 relative under the same names, every gradient
    within 1e-3 of its norm, and a gradient in the port for every tensor
    that has a nonzero one in JAX.  Returns the port model, its sample, the
    JAX gradients and the JAX draws, for the callers' further checks; a
    second call in the process returns the first one's (the JAX side's
    ``jit`` is most of the time)."""
    if name in _CHECKED:
        return _CHECKED[name]
    model, sample = conditioned_port(name)
    w_total, w_losses, w_grads, keys = jax_step(name, model, sample, monkeypatch)
    assert len(keys.uniforms) == (0 if name == "dafa" else 2)
    total, losses, grads = port_step(model, name, sample, keys.draw())
    assert sorted(losses) == sorted(w_losses)
    assert rel_err(total.numpy(), w_total) < LOSS_RTOL
    for k, v in w_losses.items():
        assert rel_err(losses[k].numpy(), v) < LOSS_RTOL, (k, float(losses[k]), float(v))
    assert set(w_grads) == set(grads)
    errs = grad_errors(grads, w_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_RTOL, (worst, errs[worst])
    for n, w in w_grads.items():
        if float(torch.linalg.vector_norm(w)) > 0:
            assert grads[n] is not None, n
    _CHECKED[name] = model, sample, w_grads, keys
    return _CHECKED[name]
