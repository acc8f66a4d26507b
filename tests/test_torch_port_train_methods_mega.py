"""The train step of MEGA (its memory and global frames as keys, three
joint stages), MEGA on the pixel path (``LOCAL.PIXEL_ATTEND`` without
relation stages: the pixel enhancement, ``global_lm``) and DAFA in the port
against the JAX package (``check_method_vs_jax`` of
``test_torch_port_train_methods.py``).  DAFA draws nothing; its global
frames' trunk pass (``extract_topk``, under gradient) reaches the trunk's
gradient as in the JAX package: detaching it in the port moves the trunk's
gradient past the tolerance."""

import pytest

from diffusionvid_torch.models.dafa import SparseRCNNDAFA
from test_torch_port_train_methods import (
    GRAD_RTOL, check_method_vs_jax, grad_errors, port_step)
from test_torch_port_weights import one_thread  # noqa: F401


@pytest.mark.parametrize("name", ["mega", "mega_pixel", "dafa"])
def test_method_loss_and_gradients_vs_jax(name, monkeypatch):
    check_method_vs_jax(name, monkeypatch)


def test_dafa_global_frames_carry_gradient(monkeypatch):
    model, sample, w_grads, _ = check_method_vs_jax("dafa", monkeypatch)
    inner = SparseRCNNDAFA.extract_topk
    monkeypatch.setattr(SparseRCNNDAFA, "extract_topk",
                        lambda self, *a: inner(self, *a).detach())
    _, _, grads = port_step(model, "dafa", sample, None)
    errs = grad_errors(grads, w_grads)
    trunk = [n for n in errs if n.startswith("backbone.bottom_up.")]
    assert max(errs[n] for n in trunk) > 10 * GRAD_RTOL
