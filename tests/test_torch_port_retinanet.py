"""RetinaNet in the port against the JAX package.

On seeded numpy weights and inputs at depth 18 on 96x128 (2,313 anchors
over P3–P7): the anchors, equal; the detections of two images (labels and
valid masks equal, scores and boxes within 1e-3); the post-processing on
tied scores (``lax.top_k`` keeps the lower index); ``losses`` and its
gradients in the logits and deltas against ``jax.value_and_grad`` (GT with
an invalid slot, anchors in the ignore band); the ``train=True`` forward's
losses and every parameter's gradient against ``jax.value_and_grad`` over
the JAX tree; ``build_detection_model`` on ``MODEL.RETINANET_ON``, the JAX tree's names
carried over, and ``--torch-weights`` copying what the JAX loader copies
(the trunk and the FPN of a reference DiffusionVID file).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.config import load_config as jax_load_config
from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
from diffusionvid_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.config import load_config
from diffusionvid_torch.models.detectors import build_detection_model
from diffusionvid_torch.models.retinanet import RetinaNet
from diffusionvid_torch.utils.convert import (_flatten, _torch_name, load_weights_into,
                                              state_dict_from_jax)
from test_torch_port_mega import reference_pth  # noqa: F401  (the shared fixture)
from test_torch_port_still import seeded_params
from test_torch_port_weights import one_thread, rel_err  # noqa: F401  (one_thread: the fixture)

ROOT = Path(__file__).resolve().parent.parent
H, W = 96, 128
CLASSES = 4
RTOL = 1e-3


@pytest.fixture(scope="module")
def retina():
    """(JAX model, params, port model): the class logits' bias raised by
    2.5, so that scores above 0.05 spread over the anchors."""
    jmodel = JaxRetinaNet(depth=18, num_classes=CLASSES)
    params = seeded_params(jmodel, jnp.zeros((1, H, W, 3)), (H, W), seed=4)
    params["head"]["cls_logits"]["bias"] = params["head"]["cls_logits"]["bias"] + np.float32(2.5)
    model = RetinaNet(depth=18, num_classes=CLASSES)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, model.eval()


def _images(seed, n=2):
    return np.random.RandomState(seed).uniform(0, 255, (n, H, W, 3)).astype(np.float32)


def test_anchors_match(retina):
    jmodel, params, model = retina
    shapes = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
    want = jmodel.apply({"params": params}, shapes, method=JaxRetinaNet._anchors)
    got = model.anchors(shapes, "cpu")
    assert got.shape == (9 * (192 + 48 + 12 + 4 + 1), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _agree(got, want):
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("scores", "boxes"):
        assert rel_err(getattr(got, k).numpy(), getattr(want, k)) < RTOL, k


def test_detections_match(retina):
    jmodel, params, model = retina
    images = _images(0)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, (H, W)))(params, images)
    with torch.no_grad():
        got = model(torch.from_numpy(images), (float(H), float(W)))
    assert got.boxes.shape == (2, 100, 4)
    assert int(got.valid.sum()) > 50
    _agree(got, want)


def test_postprocess_keeps_the_lower_index_on_ties(retina):
    """Logits in five values over 300 anchors x 4 classes: the first 1000
    of the 1,200 tied scores in ``lax.top_k``'s order, then the NMS."""
    jmodel, params, model = retina
    rng = np.random.RandomState(1)
    logits = rng.choice([-3.0, -1.0, 0.0, 1.0, 2.0], (300, CLASSES)).astype(np.float32)
    deltas = (0.3 * rng.randn(300, 4)).astype(np.float32)
    anchors = model.anchors([(10, 10), (5, 5), (3, 3), (2, 2), (1, 1)], "cpu")[:300]
    for hw in ((H, W), (60.0, 80.0)):
        want = jmodel.apply({"params": params}, logits[None], deltas[None],
                            jnp.asarray(anchors.numpy()), hw,
                            method=lambda m, c, d, a, s: m.postprocess(c, d, a, s))
        got = model.postprocess(torch.from_numpy(logits), torch.from_numpy(deltas), anchors, hw)
        _agree(type(got)(*(t[None] for t in got)), want)


def _gt(seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 70, (2, 3, 2))
    gt = np.concatenate([xy, xy + rng.uniform(12, 50, (2, 3, 2))], -1).astype(np.float32)
    labels = rng.randint(1, CLASSES + 1, (2, 3)).astype(np.int32)
    valid = np.array([[True, True, False], [True, True, True]])
    return gt, labels, valid


def test_losses_and_gradients_match(retina):
    jmodel, params, model = retina
    rng = np.random.RandomState(2)
    anchors = model.anchors([(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)], "cpu")
    n = anchors.shape[0]
    cls = rng.randn(2, n, CLASSES).astype(np.float32) - 2.0
    box = (0.5 * rng.randn(2, n, 4)).astype(np.float32)
    gt, labels, valid = _gt(3)

    def jax_total(c, b):
        out = jmodel.apply({"params": params}, c, b, jnp.asarray(anchors.numpy()), gt, labels,
                           valid, method=JaxRetinaNet.losses)
        return out["loss_retina_cls"] + out["loss_retina_reg"], out

    (_, want), (gc, gb) = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1),
                                                     has_aux=True))(cls, box)
    c, b = (torch.from_numpy(a).requires_grad_() for a in (cls, box))
    got = model.losses(c, b, anchors, *(torch.from_numpy(a) for a in (gt, labels, valid)))
    sum(got.values()).backward()
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    assert float(want["loss_retina_reg"]) > 0
    assert rel_err(c.grad.numpy(), gc) < 1e-5 and rel_err(b.grad.numpy(), gb) < 1e-5


def test_train_forward_and_parameter_gradients_match(retina):
    """The ``train=True`` forward on two images: both losses within 1e-4,
    each parameter's gradient within 1e-3 of its norm."""
    jmodel, params, model = retina
    images = _images(5)
    gt, labels, valid = _gt(6)

    def jax_total(p):
        out = jmodel.apply({"params": p}, images, (H, W), gt, labels, valid, train=True)
        return out["loss_retina_cls"] + out["loss_retina_reg"], out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(params)
    model.zero_grad()
    got = model.train_loss(torch.from_numpy(images),
                           *(torch.from_numpy(a) for a in (gt, labels, valid)))
    sum(got.values()).backward()
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    grads = {k: np.asarray(v) for k, v in state_dict_from_jax(jgrads).items()}
    worst = max((float(np.linalg.norm(p.grad.numpy() - grads[n])
                       / max(np.linalg.norm(grads[n]), 1e-12)), n)
                for n, p in model.named_parameters())
    assert worst[0] < 1e-3, worst
    model.zero_grad()


def test_build_detection_model_names_and_reference_weights(retina, reference_pth):  # noqa: F811
    """``MODEL.RETINANET_ON`` on ``configs/vid_R_50_C4_1x.yaml`` (depth 18):
    the JAX ``build_detection_model``'s RetinaNet, every name of its tree a tensor of the
    port's of the same shape; a reference DiffusionVID file copies its trunk
    and FPN into both, count for count, and no head tensor."""
    path = str(ROOT / "configs" / "vid_R_50_C4_1x.yaml")
    opts = ["MODEL.RESNETS.DEPTH", "18", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RETINANET_ON",
            "True", "MODEL.RETINANET.NUM_CLASSES", str(CLASSES)]
    ref = jax_build(jax_load_config(path, opts))
    model = build_detection_model(load_config(path, opts), device="cpu")
    assert type(model).__name__ == type(ref).__name__ == "RetinaNet"
    for attr in ("num_classes", "scales_per_octave", "octave", "fg_iou", "bg_iou", "loss_alpha",
                 "loss_gamma", "reg_beta", "reg_weight", "pre_nms_top_n", "score_thresh",
                 "nms_thresh", "detections"):
        assert getattr(model, attr) == getattr(ref, attr), attr
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                                             (H, W)))["params"]
    state = model.state_dict()
    names = {_torch_name(p, (3, 4, 5)): v.shape for p, v in _flatten(shapes)}
    assert names.keys() == state.keys()
    assert all(tuple(state[k].shape) == tuple(s) for k, s in names.items())

    _, copied = jax_merge_pretrained(retina[1], load_torch_checkpoint(reference_pth)["params"],
                                     skip_keys=())
    head = {k: v.clone() for k, v in state.items() if k.startswith(("head.", "p6.", "p7."))}
    assert copied > 100
    assert load_weights_into(model, reference_pth) == copied
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in head.items())
    pth = torch.load(reference_pth)["model"]
    for k in ("backbone.bottom_up.res5.1.conv3.weight", "backbone.fpn_output3.weight"):
        assert torch.equal(after[k], pth[k]), k
