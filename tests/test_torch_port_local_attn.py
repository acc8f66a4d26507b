"""The local temporal attention (``ATTENTION.ENABLE``) against the JAX package.

A depth-18 model (16 proposals, 1 shared + 1 conditioned stage) on 64x96
frames with ATTENTION.STAGE 1 or 2 and GLOBAL.ENABLE on or off.  The
weights are the port's random ones, carried to JAX by the JAX package's
``convert_torch_state_dict`` with the local attention added by
``_jax_params`` (the JAX converter has no rule for it; ROADMAP.md C).

  * streaming frame by frame against the JAX ``StreamingDetector`` on its
    own draws (``test_torch_port_stream.run_both``): scores and boxes to
    1e-3 relative, labels and keep masks equal;
  * the train loss and every gradient against ``jax.value_and_grad`` on
    samples of 1 + 2 local + 2 global frames, so that the conditioned stage
    and every stage's outputs are sliced to the first 3 frames: the loss to
    1e-4 relative, each gradient within 1e-3 of its norm;
  * the parameters that take no gradient: the local stages' whose output
    is overwritten (all of them under the global attention, all but the
    last without it);
  * the weight carrier and the parameter groups for the new names.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionvid_tpu.engine import train as jt
from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch
from diffusionvid_tpu.utils.torch_convert import convert_torch_state_dict

from diffusionvid_torch.config import load_config
from diffusionvid_torch.engine import train as tt
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.utils.convert import state_dict_from_jax
from chip_smoke import conditioned_train_model
from test_torch_port_stream import _frames_agree, run_both
from test_torch_port_weights import PROPS, one_thread, rel_err  # noqa: F401

LOCAL = re.compile(r"head\.local_(attention|norm)\.(\d+)\.(.+)")



def _jax_params(model):
    """The port model's weights as a JAX parameter tree."""
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    local = {k: state.pop(k) for k in list(state) if LOCAL.fullmatch(k)}
    params = convert_torch_state_dict(state)["params"]
    assert "_unmatched" not in params
    for name, v in local.items():
        kind, idx, rest = LOCAL.fullmatch(name).groups()
        node = params["head"].setdefault(f"local_{'attn' if kind == 'attention' else 'norm'}{idx}",
                                         {})
        *mids, leaf = rest.split(".")
        for k in mids:
            node = node.setdefault(k, {})
        node[leaf] = v
    return jax.tree_util.tree_map(jnp.asarray, params)


def _stream_model(stage: int, global_enable: bool, seed: int = 0):
    """Random port weights with the conv layers at fan-in variance and the
    head's 1-D parameters perturbed (as ``jax_model_and_params`` sets up the
    JAX side), so that proposal features differ."""
    gen = torch.Generator().manual_seed(seed)
    model = DiffusionDetArch(depth=18, num_classes=5, num_proposals=PROPS, num_heads=1,
                             num_heads_local=1, local_stages=stage,
                             global_enable=global_enable, compute_dtype=torch.float32)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.mul_((p.shape[0] / p.shape[1]) ** 0.5)
            elif p.dim() == 1 and name.startswith("head."):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model.eval()


COMBOS = [(1, True), (2, True), (1, False), (2, False)]


@pytest.fixture(scope="module", params=COMBOS, ids=lambda c: f"stage{c[0]}_global{int(c[1])}")
def stream_runs(request):
    stage, global_enable = request.param
    model = _stream_model(stage, global_enable)
    jmodel = JaxArch(depth=18, num_classes=5, num_proposals=PROPS, num_heads=1,
                     num_heads_local=1, local_stages=stage, global_enable=global_enable,
                     compute_dtype=jnp.float32)
    return run_both(jmodel, {"params": _jax_params(model)}, n_chunks=1)


def test_stream_frame_by_frame(stream_runs):
    jmem, jdets, mem, dets = stream_runs
    for jm, m in zip(jmem, mem):
        assert m.count == int(jm.count)
        assert rel_err(m.feats.numpy(), jm.feats) < 1e-3
    _frames_agree(jdets[0], dets[0])


def test_local_chain_conditions_without_global():
    """With GLOBAL.ENABLE off the local chain is the condition: other local
    keys move the detections; with it on they do not; without local keys
    there is no condition and ``condition`` raises, as JAX's does."""
    torch.manual_seed(0)
    feats = [torch.randn(2, s, s, 256) for s in (8, 4, 2)]
    boxes = torch.tensor([[4.0, 4.0, 40.0, 30.0]]).repeat(2, PROPS, 1)
    pro = torch.randn(2, PROPS, 256)
    t = torch.full((2,), 999)
    mem, mask = torch.randn(10, 256), torch.ones(10, dtype=torch.bool)
    for global_enable in (False, True):
        head = _stream_model(2, global_enable).head
        run = [head.condition(feats, (1 / 8, 1 / 16, 1 / 32), boxes, pro, t, mem, mask,
                              local_kv=(torch.randn(30, 256), torch.randn(10, 256)))[0][-1]
               for _ in range(2)]
        assert torch.equal(run[0], run[1]) == global_enable
    with pytest.raises(ValueError, match="conditioning signal"):
        head = _stream_model(1, False).head
        head.condition(feats, (1 / 8, 1 / 16, 1 / 32), boxes, pro, t, mem, mask)


# ---------------------------------------------------------------- train step

P, H, W, S, G, K = 50, 64, 96, 2, 6, 5
NUM_LOCAL, NUM_GLOBAL = 2, 2
B = 1 + NUM_LOCAL + NUM_GLOBAL
NL = 3
# classifier-free guidance on the local frames: frame 1 is nulled (uniform < 0.1)
CFG_UNIFORM = np.asarray([0.5, 0.05, 0.7], np.float32)


def _batch(seed=0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, 70, (S, B, G, 2))
    wh = r.uniform(6, 40, (S, B, G, 2))
    valid = r.uniform(size=(S, B, G)) < 0.6
    valid[:, :, 0] = True
    valid[1, 2] = False                      # a local frame without GT
    return (r.uniform(0, 255, (S, B, H, W, 3)).astype(np.float32),
            np.concatenate([xy, xy + wh], -1).astype(np.float32),
            r.randint(1, K + 1, (S, B, G)).astype(np.int32), valid,
            np.tile(np.asarray([[W, H, W, H]], np.float32), (S, 1)))


def _draws(rng):
    """The draws JAX's ``make_loss_fn`` makes from ``rng``, per sample; the
    null mask's local frames are CFG_UNIFORM's, the rest never read."""
    t, noise, place = [], [], []
    for srng in jax.random.split(rng, S):
        r_noise, _ = jax.random.split(srng)
        r_t, r_n, r_place, _ = jax.random.split(r_noise, 4)
        t.append(np.asarray(jax.random.randint(r_t, (B,), 0, 1000)))
        noise.append(np.asarray(jax.random.normal(r_n, (B, P, 4))))
        place.append(np.asarray(jax.random.normal(r_place, (B, P, 4))))
    null = np.zeros((S, B), bool)
    null[:, :NL] = CFG_UNIFORM < 0.1
    return tt.TrainDraws(*[torch.from_numpy(np.stack(x)) for x in (t, noise, place)],
                         torch.from_numpy(null))


def _train_model(stage, global_enable):
    arch = dict(depth=18, num_classes=K, num_proposals=P, num_heads=2, num_heads_local=1,
                local_stages=stage, global_enable=global_enable)
    model = conditioned_train_model(torch.Generator().manual_seed(0),
                                    torch.from_numpy(_batch()[0][0]), **arch)
    return model, arch


def _port_batch(arrays):
    img, boxes, labels, valid, whwh = [torch.from_numpy(np.array(a)) for a in arrays]
    return tt.TrainBatch(img, boxes, labels.long(), valid, whwh)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    _, arch = _train_model(2, False)
    loss_fn = jt.make_loss_fn(JaxArch(**arch, compute_dtype=jnp.float32), NUM_GLOBAL)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def jax_train_step(m: int = 0) -> dict:
    """The JAX train step of ``_train_model(2, False)`` on ``_batch(m)``
    with ``PRNGKey(5 + m)``: its loss, losses and gradient (by port name).
    One jitted function, which ``test_torch_port_ddp.py`` shares."""
    model, _ = _train_model(2, False)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax.random, "uniform",
                    lambda key, shape=(), *a, **k: jnp.asarray(CFG_UNIFORM))
        (total, losses), grads = _jax_value_and_grad()(
            _jax_params(model), jt.TrainBatch(*[jnp.asarray(a) for a in _batch(m)]),
            jax.random.PRNGKey(5 + m))
    return {"total_loss": float(total), "losses": {k: float(v) for k, v in losses.items()},
            "grads": state_dict_from_jax(grads)}


def test_train_loss_and_gradients_vs_jax():
    """STAGE 2 without the global attention: the local chain conditions the
    stage, keyed on the first 3 frames' top-k features; the outputs and the
    losses cover those frames only."""
    model, arch = _train_model(2, False)
    arrays = _batch()
    draws = _draws(jax.random.PRNGKey(5))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(arrays[0][0]), torch.rand(B, P, 4) * 40,
                          draws.t[0], NUM_GLOBAL, draws.null[0])
    assert logits.shape == (3, NL, P, K)

    ref = jax_train_step(0)
    total, losses = tt.make_loss_fn(model, NUM_GLOBAL)(_port_batch(arrays), draws)
    total.backward()
    assert rel_err(total.detach(), ref["total_loss"]) < 1e-4
    assert sorted(losses) == sorted(ref["losses"])
    for k, v in ref["losses"].items():
        assert rel_err(losses[k].detach(), v) < 1e-4, k
    want = ref["grads"]
    got = dict(model.named_parameters())
    assert set(want) == set(got) and any(LOCAL.fullmatch(n) for n in want)
    idle = set(tt.unused_in_training(model))
    assert idle and all(n.startswith(("head.local_attention.0.", "head.local_norm.0."))
                        for n in idle)
    for name, w in want.items():
        g = got[name].grad
        wn = float(torch.linalg.vector_norm(w))
        if name in idle:        # stage 0's output is overwritten by stage 1's
            assert g is None and wn == 0, name
            continue
        assert g is not None, name
        err = float(torch.linalg.vector_norm(g - w))
        assert err <= 1e-3 * max(wn, 1e-8), f"{name}: |dg| {err} vs |g| {wn}"
        if LOCAL.fullmatch(name) and name.endswith("weight"):
            assert wn > 0, name


@pytest.mark.parametrize("stage,global_enable", [(1, True), (2, True), (2, False), (0, True)])
def test_parameters_without_gradient(stage, global_enable):
    """The parameters that take no gradient in a train step are exactly
    ``unused_in_training``: every local stage's when the global attention
    overwrites the local chain's output, every local stage's but the last
    without it, none without the local attention (the DDP wrapper's
    ``find_unused_parameters`` reads this)."""
    model, _ = _train_model(stage, global_enable)
    one = [a[:1] for a in _batch()]              # the first sample
    draws = tt.TrainDraws(*[x[:1] for x in _draws(jax.random.PRNGKey(1))])
    total, _ = tt.make_loss_fn(model, NUM_GLOBAL)(_port_batch(one), draws)
    total.backward()
    none = {n for n, p in model.named_parameters() if p.grad is None}
    assert none == set(tt.unused_in_training(model))
    assert bool(none) == (stage > 1 or (stage > 0 and global_enable))


def test_weight_carrier_and_param_groups():
    """JAX ``local_attn{i}`` / ``local_norm{i}`` carry to
    ``head.local_attention.{i}.*`` / ``head.local_norm.{i}.*`` and load
    strictly; their groups are the JAX labels; the JAX package's converter
    has no rule for these names (they land in ``_unmatched``)."""
    model = _stream_model(2, True)
    params = _jax_params(model)
    assert {"local_attn0", "local_attn1", "local_norm0", "local_norm1"} <= set(params["head"])
    state = state_dict_from_jax(params)
    again = _stream_model(2, True, seed=1)
    again.load_state_dict(state, strict=True)
    for name, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], v), name
    labels = {}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, _ in flat:
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[1].startswith("local_"):
            torch_name = [n for n in state if n.startswith("head.local_")
                          and n.endswith(".".join(keys[2:]))
                          and n.split(".")[2] == re.sub(r"\D", "", keys[1])
                          and ("attention" in n) == ("attn" in keys[1])]
            assert len(torch_name) == 1, keys
            labels[torch_name[0]] = jt._param_label(path)
    assert len(labels) == 12
    for name, label in labels.items():
        assert tt.param_group(name) == label, name
    unmatched = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})["params"]["_unmatched"]
    assert sorted(unmatched) == sorted(n for n in model.state_dict() if LOCAL.fullmatch(n))


def test_config_builds_local_stages():
    """``from_config`` reads ATTENTION.ENABLE and STAGE; the train CLI then
    samples REF_NUM_LOCAL local refs."""
    from diffusionvid_torch.tools.train_net import train_sample_config
    cfg = load_config("configs/vid_R_50_tiny_synthetic.yaml",
                      ["MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE", "True",
                       "MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE", "2"])
    model = DiffusionDetArch.from_config(cfg, device="cpu")
    assert model.local_stages == 2 and len(model.head.local_attention) == 2
    assert train_sample_config(cfg).num_local == cfg.MODEL.VID.MEGA.REF_NUM_LOCAL == 2
    cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE = False
    assert DiffusionDetArch.from_config(cfg, device="cpu").local_stages == 0
    assert train_sample_config(cfg).num_local == 0
