"""The port's losses, GIoU and simOTA criterion against the JAX package.

CPU, float32, numpy inputs from seeds on both sides.  The matcher is
discrete: each test first asserts that both sides chose the same
``matched_gt`` and ``fg``, then compares the losses to 1e-5 relative.  The
inputs hold exact ties (duplicated proposals and GT boxes), invalid GT
slots, a frame without GT and GT pairs that fight over one proposal, so the
stable sorts, the first-index argmin/argmax and the repair pass all decide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionvid_tpu.models import criterion as jc
from diffusionvid_tpu.ops import losses as jl
from diffusionvid_tpu.structures import boxes as jb

from diffusionvid_torch.models import criterion as tc
from diffusionvid_torch.ops import losses as tl
from diffusionvid_torch.structures import boxes as tb
from test_torch_port_weights import rel_err

K = 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, shape, lo=0.0, hi=80.0, size=(2.0, 50.0)):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(*size, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _match_inputs(seed, b=4, n=40, g=8):
    """Frames of proposals against padded GT with ties, invalid slots and
    conflicts; frame 1 has no valid GT."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, n, K).astype(np.float32) * 2
    boxes = _boxes(rng, (b, n))
    gt = _boxes(rng, (b, g), size=(8.0, 40.0))
    labels = rng.randint(1, K + 1, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) < 0.75
    valid[1] = False
    # exact ties: duplicated proposals (boxes and logits) and GT boxes
    boxes[:, 7] = boxes[:, 3]
    logits[:, 7] = logits[:, 3]
    gt[:, 5] = gt[:, 2]
    valid[0, [2, 5]] = True
    # proposals that sit on a GT, so several GTs want them
    boxes[:, 10:14] = gt[:, [0, 2, 5, 6]] + rng.uniform(-1, 1, (b, 4, 4)).astype(np.float32)
    whwh = np.tile(np.asarray([[128.0, 96.0, 128.0, 96.0]], np.float32), (b, 1))
    return logits, boxes, labels, gt, valid, whwh


def test_sigmoid_losses_vs_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 30, K) * 4).astype(np.float32)
    logits[0, :3] = [[0.0] * K, [50.0] * K, [-50.0] * K]
    targets = (rng.uniform(size=logits.shape) < 0.2).astype(np.float32)
    for got, want in ((tl.sigmoid_focal_loss(_t(logits), _t(targets)),
                       jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets))),
                      (tl.sigmoid_focal_loss(_t(logits), _t(targets), alpha=-1.0, gamma=1.5),
                       jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                             alpha=-1.0, gamma=1.5)),
                      (tl.sigmoid_ce(_t(logits), _t(targets)),
                       jl.optax_sigmoid_ce(jnp.asarray(logits), jnp.asarray(targets)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    pred, target = logits[..., :4], logits[..., 1:] * 0.9
    np.testing.assert_allclose(tl.smooth_l1_loss(_t(pred), _t(target)).numpy(),
                               np.asarray(jl.smooth_l1_loss(jnp.asarray(pred),
                                                            jnp.asarray(target))),
                               rtol=1e-6, atol=1e-7)


def test_giou_vs_jax():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, (3, 17)), _boxes(rng, (3, 11))
    a[0, 0] = [5, 5, 5, 20]          # zero width
    b[0, 0] = a[0, 0]                # identical degenerate boxes
    b[1, :2] = a[1, :2]              # identical boxes
    got = tb.pairwise_giou(_t(a), _t(b)).numpy()
    for f in range(3):
        want = np.asarray(jb.pairwise_giou(jnp.asarray(a[f]), jnp.asarray(b[f])))
        np.testing.assert_allclose(got[f], want, rtol=1e-5, atol=1e-6)
    got = tb.elementwise_giou(_t(a[:, :11]), _t(b)).numpy()
    want = np.asarray(jb.elementwise_giou(jnp.asarray(a[:, :11]), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_match(inputs):
    return jax.vmap(jc.simota_match)(*[jnp.asarray(x) for x in inputs])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_match_vs_jax(seed):
    inputs = _match_inputs(seed)
    want = _jax_match(inputs)
    got = tc.simota_match(*[_t(x) for x in inputs])
    np.testing.assert_array_equal(got.fg.numpy(), np.asarray(want.fg))
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    valid = inputs[4]
    # every valid GT got a proposal (the repair pass), frame 1 none at all
    for f in range(valid.shape[0]):
        assert set(got.matched_gt[f][got.fg[f]].tolist()) == set(np.nonzero(valid[f])[0])


def test_simota_repair_pass_decides():
    """Two identical GTs with dynamic k = 1 want the same proposal: the
    conflict keeps the first GT (first-index argmin over exact ties) and
    the repair pass gives the second its next-cheapest free proposal."""
    logits, boxes, labels, gt, valid, whwh = _match_inputs(3, b=2, n=16)
    gt[:, 1] = gt[:, 0]
    labels[:, 1] = labels[:, 0]
    valid[:] = False
    valid[:, :2] = True
    boxes[:] = _boxes(np.random.RandomState(9), (2, 16), lo=200.0, hi=300.0)   # far away
    boxes[:, 4] = gt[:, 0] + 0.5
    inputs = (logits, boxes, labels, gt, valid, whwh)
    want = _jax_match(inputs)
    got = tc.simota_match(*[_t(x) for x in inputs])
    np.testing.assert_array_equal(got.fg.numpy(), np.asarray(want.fg))
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    for f in range(2):
        assert got.fg[f, 4] and got.matched_gt[f, 4] == 0
        assert int(got.fg[f].sum()) == 2 and 1 in got.matched_gt[f][got.fg[f]].tolist()


def test_criterion_losses_vs_jax():
    inputs = _match_inputs(4)
    want = jc.criterion_losses(*[jnp.asarray(x) for x in inputs], K)
    got = tc.criterion_losses(*[_t(x) for x in inputs], K)
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) < 1e-5, k


def test_set_criterion_vs_jax():
    """Three stages with stage-dependent predictions; per-stage losses and
    the weighted total."""
    logits, boxes, labels, gt, valid, whwh = _match_inputs(5, b=3)
    rng = np.random.RandomState(6)
    all_logits = np.stack([logits + rng.randn(*logits.shape).astype(np.float32)
                           for _ in range(3)])
    all_boxes = np.stack([boxes + rng.uniform(-3, 3, boxes.shape).astype(np.float32)
                          for _ in range(3)])
    args = (all_logits, all_boxes, labels, gt, valid, whwh)
    for s in range(3):
        want = _jax_match((all_logits[s], all_boxes[s], labels, gt, valid, whwh))
        got = tc.simota_match(*[_t(x) for x in (all_logits[s], all_boxes[s], labels, gt,
                                                 valid, whwh)])
        np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
        np.testing.assert_array_equal(got.fg.numpy(), np.asarray(want.fg))
    w_total, w_losses = jc.set_criterion(*[jnp.asarray(x) for x in args], K)
    g_total, g_losses = tc.set_criterion(*[_t(x) for x in args], K)
    assert sorted(g_losses) == sorted(w_losses)
    assert "loss_ce" in g_losses and "loss_giou_1" in g_losses
    for k in w_losses:
        assert rel_err(g_losses[k].numpy(), w_losses[k]) < 1e-5, k
    assert rel_err(g_total.numpy(), w_total) < 1e-5


def test_criterion_gradient_vs_jax():
    """The criterion's gradient with respect to the predictions."""
    logits, boxes, labels, gt, valid, whwh = _match_inputs(7, b=2)

    def jloss(lg, bx):
        return jc.set_criterion(lg[None], bx[None], *[jnp.asarray(x) for x in
                                                      (labels, gt, valid, whwh)], K)[0]

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(boxes))
    lg, bx = _t(logits).requires_grad_(), _t(boxes).requires_grad_()
    tc.set_criterion(lg[None], bx[None], *[_t(x) for x in (labels, gt, valid, whwh)],
                     K)[0].backward()
    assert rel_err(lg.grad.numpy(), want[0]) < 1e-5
    assert rel_err(bx.grad.numpy(), want[1]) < 1e-5
