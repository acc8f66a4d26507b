"""The train step of ``base``, DFF, FGFA and RDN in the port against the
JAX package (``check_method_vs_jax`` of ``test_torch_port_train_methods.py``:
depth 18, 64x96 frames, the JAX package's draws, losses within 1e-4
relative, every gradient within 1e-3 of its norm).  RDN with and without
its advanced stage; and RDN's reference proposals stay on the gradient
path, as in the JAX package: detaching them in the port moves the RPN's
gradient past the tolerance."""

import pytest
import torch

from diffusionvid_torch.models import rcnn
from test_torch_port_train_methods import (
    GRAD_RTOL, check_method_vs_jax, grad_errors, port_step)
from test_torch_port_weights import one_thread  # noqa: F401


@pytest.mark.parametrize("name", ["base", "dff", "fgfa", "rdn", "rdn_advanced"])
def test_method_loss_and_gradients_vs_jax(name, monkeypatch):
    check_method_vs_jax(name, monkeypatch)


def test_rdn_reference_proposals_carry_gradient(monkeypatch):
    """The references' boxes reach the RPN through the position embedding
    and the pooling: with them detached the port's RPN gradient leaves
    the JAX package's."""
    model, sample, w_grads, keys = check_method_vs_jax("rdn", monkeypatch)
    inner = rcnn.GeneralizedRCNN.proposals

    def detached(self, feat, image_hw, ref=False):
        props = inner(self, feat, image_hw, ref)
        return type(props)(*(t.detach() for t in props)) if ref else props

    monkeypatch.setattr(rcnn.GeneralizedRCNN, "proposals", detached)
    _, _, grads = port_step(model, "rdn", sample, keys.draw())
    errs = grad_errors(grads, w_grads)
    assert errs["detector.rpn.bbox_pred.weight"] > 10 * GRAD_RTOL
    assert max(errs[n] for n in errs if not n.startswith("detector.")) < GRAD_RTOL
    assert torch.linalg.vector_norm(grads["detector.rpn.bbox_pred.weight"]) > 0
