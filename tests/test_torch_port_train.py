"""The port's train step against the JAX package's, and its resume.

A depth-18 model with 2 shared + 1 conditioned stages, 50 proposals, 64x96
frames, S = 2 samples of 1 + 2 frames, float32 on the CPU.  The weights are
the port's, carried to JAX by the JAX package's ``convert_torch_state_dict``;
the random draws are JAX's: the test repeats ``jax.random.split`` for the
diffusion targets, and the classifier-free-guidance null mask is fixed on
both sides by patching ``jax.random.uniform``.  Tolerances: the stage
outputs 1e-3 relative (the DynamicHead's), the same simOTA assignments,
the losses 1e-4 relative, every parameter's gradient 1e-3 relative in
norm, the FrozenBN weights' and running statistics' included.  The
optimizer is held against ``optax`` over 3 updates to 1e-6 relative; a
resumed run equals an uninterrupted one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusionvid_tpu.engine import train as jt
from diffusionvid_tpu.models import criterion as jc
from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch
from diffusionvid_tpu.models.diffusion_det import make_schedule as j_make_schedule
from diffusionvid_tpu.models.diffusion_det import (
    prepare_diffusion_targets as j_prepare_targets)
from diffusionvid_tpu.utils.torch_convert import convert_torch_state_dict

from diffusionvid_torch.engine import train as tt
from diffusionvid_torch.models import criterion as tc
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.models.diffusion_det import make_schedule, prepare_diffusion_targets
from diffusionvid_torch.models.resnet import FrozenBatchNorm2d
from diffusionvid_torch.utils import checkpoint as ck
from diffusionvid_torch.utils.convert import state_dict_from_jax
from chip_smoke import conditioned_train_model
from test_torch_port_weights import one_thread, rel_err  # noqa: F401

P, H, W, S, B, G, K, NUM_GLOBAL = 50, 64, 96, 2, 3, 6, 5, 2
ARCH = dict(depth=18, num_classes=K, num_proposals=P, num_heads=2, num_heads_local=1)
# classifier-free guidance: frame 1 of every sample is nulled (uniform < 0.1)
CFG_UNIFORM = np.asarray([0.5, 0.05, 0.7], np.float32)


def _port_model(seed=0, arch=ARCH):
    """The tiny model, set up so that the two sides' gradients compare well
    (``chip_smoke.conditioned_train_model``: every ReLU far from its kink)."""
    return conditioned_train_model(torch.Generator().manual_seed(seed),
                                   torch.from_numpy(_batch()[0][0]), **arch)


def _jax_params(model):
    tree = convert_torch_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    assert "_unmatched" not in tree
    return jax.tree_util.tree_map(jnp.asarray, tree["params"])


def _batch(seed=0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, 70, (S, B, G, 2))
    wh = r.uniform(6, 40, (S, B, G, 2))
    valid = r.uniform(size=(S, B, G)) < 0.6
    valid[:, :, 0] = True
    valid[1, 2] = False                      # a frame without GT
    return (r.uniform(0, 255, (S, B, H, W, 3)).astype(np.float32),
            np.concatenate([xy, xy + wh], -1).astype(np.float32),
            r.randint(1, K + 1, (S, B, G)).astype(np.int32), valid,
            np.tile(np.asarray([[W, H, W, H]], np.float32), (S, 1)))


def _port_batch(arrays):
    img, boxes, labels, valid, whwh = [torch.from_numpy(np.array(a)) for a in arrays]
    return tt.TrainBatch(img, boxes, labels.long(), valid, whwh)


def _jax_draws(rng):
    """The draws ``make_loss_fn`` makes from ``rng``, per sample."""
    t, noise, place = [], [], []
    for srng in jax.random.split(rng, S):
        r_noise, _ = jax.random.split(srng)
        r_t, r_n, r_place, _ = jax.random.split(r_noise, 4)
        t.append(np.asarray(jax.random.randint(r_t, (B,), 0, 1000)))
        noise.append(np.asarray(jax.random.normal(r_n, (B, P, 4))))
        place.append(np.asarray(jax.random.normal(r_place, (B, P, 4))))
    null = np.tile(CFG_UNIFORM < 0.1, (S, 1))
    return tt.TrainDraws(*[torch.from_numpy(np.stack(x)) for x in (t, noise, place)],
                         torch.from_numpy(null))


@pytest.fixture
def fixed_cfg_mask(monkeypatch):
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(CFG_UNIFORM))


def test_prepare_diffusion_targets_on_jax_draws():
    arrays = _batch(1)
    gt, valid, whwh = arrays[1][0], arrays[3][0], np.tile(arrays[4][0], (B, 1))
    valid[1] = False                         # the fallback full-image box
    rng = jax.random.PRNGKey(3)
    want, want_t = j_prepare_targets(rng, j_make_schedule(), jnp.asarray(gt),
                                     jnp.asarray(valid), jnp.asarray(whwh), P)
    r_t, r_n, r_place, _ = jax.random.split(rng, 4)
    t = torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, 1000)))
    noise = torch.from_numpy(np.array(jax.random.normal(r_n, (B, P, 4))))
    place = torch.from_numpy(np.array(jax.random.normal(r_place, (B, P, 4))))
    got = prepare_diffusion_targets(make_schedule(), torch.from_numpy(gt),
                                    torch.from_numpy(valid), torch.from_numpy(whwh),
                                    t.long(), noise, place)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def _train_vs_jax(arch):
    """The stage outputs, assignments, losses and gradients of the model
    ``arch`` against the JAX package's, as the module docstring says."""
    stages = arch["num_heads"] + arch["num_heads_local"]
    model = _port_model(arch=arch)
    params = _jax_params(model)
    jmodel = JaxArch(**arch, compute_dtype=jnp.float32)
    arrays = _batch()
    jbatch = jt.TrainBatch(*[jnp.asarray(a) for a in arrays])
    rng = jax.random.PRNGKey(5)
    draws = _jax_draws(rng)

    # the stage outputs and the assignments, sample by sample
    sched = j_make_schedule()
    fwd = jax.jit(lambda p, im, nb, t: jmodel.apply(
        {"params": p}, im, nb, t, num_global=NUM_GLOBAL, train=True,
        rngs={"cfg": jax.random.PRNGKey(0)}))
    for s, srng in enumerate(jax.random.split(rng, S)):
        r_noise, _ = jax.random.split(srng)
        whwh_b = jnp.tile(jbatch.whwh[s][None], (B, 1))
        noisy, t = j_prepare_targets(r_noise, sched, jbatch.gt_boxes[s],
                                     jbatch.gt_valid[s], whwh_b, P)
        j_logits, j_boxes = fwd(params, jbatch.images[s], noisy, t)
        with torch.no_grad():
            logits, boxes = model(torch.from_numpy(arrays[0][s]),
                                  torch.from_numpy(np.array(noisy)), draws.t[s].long(),
                                  NUM_GLOBAL, draws.null[s])
        assert logits.shape == (stages, B, P, K) and boxes.shape == (stages, B, P, 4)
        assert rel_err(logits, j_logits) < 1e-3 and rel_err(boxes, j_boxes) < 1e-3
        gt = [arrays[i][s] for i in (2, 1, 3)]
        for st in range(stages):
            want = jax.vmap(jc.simota_match)(j_logits[st], j_boxes[st],
                                             *[jnp.asarray(a) for a in gt], whwh_b)
            got = tc.simota_match(logits[st], boxes[st],
                                  *[torch.from_numpy(a) for a in gt],
                                  torch.from_numpy(np.array(whwh_b)))
            np.testing.assert_array_equal(got.fg.numpy(), np.asarray(want.fg))
            np.testing.assert_array_equal(got.matched_gt.numpy(),
                                          np.asarray(want.matched_gt))

    loss_fn = jt.make_loss_fn(jmodel, NUM_GLOBAL)
    (w_total, w_losses), w_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, rng)

    total, losses = tt.make_loss_fn(model, NUM_GLOBAL)(_port_batch(arrays), draws)
    total.backward()
    assert rel_err(total.detach(), w_total) < 1e-4
    assert sorted(losses) == sorted(w_losses) and f"loss_ce_{stages - 2}" in losses
    for k, v in w_losses.items():
        assert rel_err(losses[k].detach(), v) < 1e-4, k

    want = state_dict_from_jax(w_grads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    checked = set()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        wn = float(torch.linalg.vector_norm(w))
        err = float(torch.linalg.vector_norm(g - w))
        assert err <= 1e-3 * max(wn, 1e-8), f"{name}: |dg| {err} vs |g| {wn}"
        if wn > 0:
            checked.add(name.rsplit(".", 1)[-1])
    # FrozenBN's four tensors have gradients on both sides
    assert {"running_mean", "running_var", "weight", "bias"} <= checked


def test_train_loss_and_gradients_vs_jax(fixed_cfg_mask):
    _train_vs_jax(ARCH)


@pytest.mark.parametrize("global_enable", [True, False], ids=["global", "no_global"])
def test_train_plain_diffusiondet_vs_jax(fixed_cfg_mask, global_enable):
    """No conditioned stage (plain DiffusionDet, NUM_HEADS_LOCAL 0), with
    GLOBAL.ENABLE set or not: the two shared stages are supervised alone."""
    _train_vs_jax(dict(ARCH, num_heads_local=0, global_enable=global_enable))


@pytest.mark.parametrize("kind", ["resnet", "swin"])
def test_param_groups_match_jax_labels(kind):
    """The port's groups are the JAX package's ``_param_label`` of the same
    tensor: the trunk is the backbone, the FPN is not; in the Swin trunk
    only the LayerNorm biases are biases (JAX names the others ``qkv_bias``,
    ``proj_bias``, ``mlp_fc1_bias``, ...)."""
    if kind == "resnet":
        model = _port_model()
    else:
        model = DiffusionDetArch(num_classes=K, num_proposals=16, num_heads=1,
                                 num_heads_local=1, backbone_type="swin", swin_size="T",
                                 fpn_in=("swin1", "swin2", "swin3"))
    codes = state_dict_from_jax(jax.tree_util.tree_map_with_path(
        lambda p, a: np.full(a.shape, tt.GROUPS.index(jt._param_label(p)), np.float32),
        _jax_params(model)))
    for name, _ in model.named_parameters():
        assert tt.param_group(name) == tt.GROUPS[int(codes[name].flatten()[0])], name
    groups = {tt.param_group(n) for n, _ in model.named_parameters()}
    assert groups == set(tt.GROUPS) - ({"frozen"} if kind == "swin" else set())
    if kind == "swin":
        trunk = "backbone.bottom_up.layers.0.blocks.1."
        assert tt.param_group(trunk + "attn.qkv.bias") == "backbone"
        assert tt.param_group(trunk + "norm1.bias") == "backbone_bias"


# a few tensors of every group: the trunk's stem (FrozenBN included), the
# FPN, the attention's fused bias and the class bias, the FFN, the time MLP
_OPT_TENSORS = ("backbone.bottom_up.stem.conv1.weight", "backbone.bottom_up.stem.conv1.norm.",
                "backbone.bottom_up.res2.0.conv2.norm.", "backbone.fpn_lateral3.",
                "head.head_series.0.self_attn.in_proj", "head.head_series.0.class_logits.",
                "head.head_series.0.linear1.", "head.time_mlp.1.")


def _module_from_state(state):
    """An nn.Module whose parameters are ``state``, under the same names."""
    root = torch.nn.Module()
    for name, v in state.items():
        *path, leaf = name.split(".")
        m = root
        for part in path:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, torch.nn.Parameter(v.clone()))
    return root


@pytest.mark.parametrize("kind", ["adamw", "sgd_cosine"])
def test_optimizer_vs_optax(kind):
    """3 updates over 6 micro-steps (ACCUMULATION_STEPS 2) of random
    gradients: linear warmup, a milestone, bias groups with their own LR
    factor and decay, the backbone multiplier, and a clip that acts.  The
    tensors are a tiny model's, each moved off zero: optax's float32 bias
    correction moves a first Adam update by about 1e-5."""
    gen = torch.Generator().manual_seed(3)
    state = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in _small_model().state_dict().items() if k.startswith(_OPT_TENSORS)}
    model = _module_from_state(state)
    params = _jax_params(model)
    kw = dict(base_lr=1e-3, steps=(2,), gamma=0.5, warmup_iters=2, warmup_factor=0.25,
              weight_decay=1e-2, weight_decay_bias=1e-3, backbone_multiplier=0.1,
              bias_lr_factor=2.0, clip_norm=5.0, accumulation_steps=2, max_iter=5)
    if kind == "sgd_cosine":
        kw.update(optimizer_type="sgd", momentum=0.9, lr_scheduler_type="cosine")
    tx = jt.make_optimizer(params, **kw)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = tt.make_optimizer(model, **kw)
    named = dict(model.named_parameters())
    assert {tt.param_group(n) for n in named} == set(tt.GROUPS)
    rng = np.random.RandomState(0)
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in state_dict_from_jax(grads).items():
            named[name].grad = g.clone()
        assert opt.accumulate() == (step % 2 == 1)
        want = state_dict_from_jax(params)
        for name, p in named.items():
            assert rel_err(p.detach(), want[name]) < 1e-6, (step, name)
    assert opt.count == 3
    for name, p in named.items():
        moved = not torch.equal(p.detach(), state[name])
        assert moved == (tt.param_group(name) != "frozen"), name


def test_schedules_vs_jax():
    for count in (0, 1, 7, 10, 11, 25, 40, 60):
        got = tt.warmup_multistep_schedule(0.02, (10, 30), 0.1, 12, 0.01)(count)
        want = float(jt.warmup_multistep_schedule(0.02, (10, 30), 0.1, 12, 0.01)(count))
        assert abs(got - want) <= 1e-6 * want, count
        got = tt.warmup_cosine_schedule(0.02, 50, 12, 0.01)(count)
        want = float(jt.warmup_cosine_schedule(0.02, 50, 12, 0.01)(count))
        assert abs(got - want) <= 1e-6 * max(want, 1e-9), count


def test_frozen_bn_is_trained_but_its_statistics_are_not():
    """The JAX package's FrozenBN deviation, mirrored: weight and bias are
    parameters of the backbone groups and move; running_mean and
    running_var are parameters that never move, yet their gradients count
    in the global-norm clip."""
    model = torch.nn.Module()
    model.backbone = torch.nn.Module()
    model.backbone.bottom_up = torch.nn.Module()
    model.backbone.bottom_up.norm = FrozenBatchNorm2d(4)
    model.head = torch.nn.Linear(4, 1, bias=False)
    names = [n for n, _ in model.named_parameters()]
    assert [tt.param_group(n) for n in names] == [
        "backbone", "backbone_bias", "frozen", "frozen", "main"]
    assert set(model.backbone.bottom_up.norm.state_dict()) == {
        "weight", "bias", "running_mean", "running_var"}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = tt.make_optimizer(model, optimizer_type="sgd", momentum=0.0, base_lr=1.0,
                            warmup_iters=0, weight_decay=0.0, weight_decay_bias=0.0,
                            backbone_multiplier=1.0, clip_norm=1.0)
    norm = model.backbone.bottom_up.norm
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    norm.running_var.grad = torch.full((4,), 50.0)       # dominates the norm
    opt.accumulate()
    total = float(np.sqrt(4 * 50.0 ** 2 + 16 * 0.5 ** 2))
    after = dict(model.named_parameters())
    for n in ("backbone.bottom_up.norm.weight", "backbone.bottom_up.norm.bias",
              "head.weight"):
        torch.testing.assert_close(before[n] - after[n].detach(),
                                   torch.full_like(before[n], 0.5 / total))
    for n in ("backbone.bottom_up.norm.running_mean", "backbone.bottom_up.norm.running_var"):
        assert torch.equal(before[n], after[n])


def _port_loader(start):
    """An endless stream of one-sample batches, each made from its
    iteration index."""
    it = start
    while True:
        yield _port_batch([a[:1] for a in _batch(100 + it)])
        it += 1


def _small_model():
    model = DiffusionDetArch(depth=18, num_classes=K, num_proposals=16, num_heads=1,
                             num_heads_local=1, compute_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(1))
    return model


@pytest.mark.parametrize("split", [2, 3])
def test_resume_is_bitexact(tmp_path, split):
    """4 micro-steps straight against ``split`` steps, a checkpoint, a new
    model and optimizer resumed from ``last_checkpoint``, then the rest;
    ACCUMULATION_STEPS 2, so split 3 saves a half-accumulated gradient."""
    kw = dict(base_lr=1e-3, warmup_iters=2, accumulation_steps=2)
    straight = _small_model()
    tt.train_loop(straight, tt.make_optimizer(straight, **kw), _port_loader(0),
                  num_global=NUM_GLOBAL, max_iter=4, seed=7, log_every=0)

    first = _small_model()
    out = str(tmp_path / "run")
    tt.train_loop(first, tt.make_optimizer(first, **kw), _port_loader(0),
                  num_global=NUM_GLOBAL, max_iter=split, seed=7, output_dir=out,
                  checkpoint_period=1, log_every=0)
    assert ck.last_checkpoint(out).endswith(f"model_{split:07d}.pth")
    resumed = _small_model()
    opt = tt.make_optimizer(resumed, **kw)
    start = tt.resume(resumed, opt, out)
    assert start == split and opt.mini_step == split % 2
    tt.train_loop(resumed, opt, _port_loader(start), num_global=NUM_GLOBAL, max_iter=4,
                  seed=7, start_iter=start, output_dir=out, checkpoint_period=2,
                  log_every=0)
    for (n, a), (_, b) in zip(straight.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), n
    assert not torch.equal(straight.head.head_series[0].linear1.weight,
                           _small_model().head.head_series[0].linear1.weight)
    assert ck.load_checkpoint(ck.last_checkpoint(out))["step"] == 4


def test_checkpoint_helpers(tmp_path):
    assert ck.last_checkpoint(str(tmp_path)) is None
    model = _small_model()
    state = model.state_dict()
    path = ck.save_checkpoint(str(tmp_path), 12, state, extra={"note": 1})
    assert ck.last_checkpoint(str(tmp_path)) == path
    loaded = ck.load_checkpoint(path)
    assert loaded["step"] == 12 and loaded["extra"] == {"note": 1} and "optimizer" not in loaded
    other = {k: torch.zeros_like(v) for k, v in state.items()}
    other["head.unknown"] = torch.ones(3)
    merged, n = ck.merge_pretrained(state, other)
    skipped = [k for k in state if "class_logits" in k]
    assert skipped and n == len(state) - len(skipped)
    assert all(torch.equal(merged[k], state[k]) for k in skipped)
    assert "head.unknown" not in merged
    kept = ck.filter_params(state)
    assert set(kept) == set(state) - set(skipped)
