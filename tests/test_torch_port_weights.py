"""The port's weight carry-over: JAX parameter tree → the port's state dict.

``convert_torch_state_dict(state_dict_from_jax(tree))`` must give back the
tree leaf for leaf with nothing unmatched, and the port's model must load
the state dict with ``strict=True``, for a ResNet and a Swin-T model.
``jax_model_and_params`` and ``port_model`` build the small JAX/port pair
the other port tests share, and ``one_thread`` is the module-wide
one-intra-op-thread fixture that the heavier port test modules import.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch
from diffusionvid_tpu.utils.torch_convert import convert_torch_state_dict

from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.utils.convert import state_dict_from_jax

H, W, PROPS = 64, 96, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small ops in the module: with
    several test workers on the host, threads that wait for each other at
    every op slow such runs many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SWIN_T = dict(backbone_type="swin", swin_size="T", fpn_in=("swin1", "swin2", "swin3"))


def jax_model_and_params(depth=18, num_classes=5, num_heads=1,
                         num_heads_local=1, res_stage=1, seed=0, swin=False,
                         global_enable=True, swin_size="T"):
    """A small fp32 JAX DiffusionDetArch initialised with ``jax.jit``: a
    ResNet of ``depth``, or with ``swin`` a Swin trunk of ``swin_size``
    (Swin-T by default)."""
    model = JaxArch(depth=depth, num_classes=num_classes, num_proposals=PROPS,
                    num_heads=num_heads, num_heads_local=num_heads_local,
                    res_stage=res_stage, compute_dtype=jnp.float32,
                    global_enable=global_enable,
                    **(dict(SWIN_T, swin_size=swin_size) if swin else {}))
    noisy = jnp.tile(jnp.asarray([8.0, 8.0, 60.0, 40.0]), (2, PROPS, 1))
    init = jax.jit(lambda r: model.init(
        {"params": r, "cfg": jax.random.PRNGKey(1)}, jnp.zeros((2, H, W, 3)),
        noisy, jnp.zeros((2,), jnp.int32), num_global=1, train=False))
    # He fan-out init shrinks the trunk's activations stage by stage, and
    # near-zero FPN maps make every proposal's features alike (the memory's
    # FPS then chooses between near-ties).  Rescale each conv to fan-in
    # variance so the maps stay O(1); both sides get the same weights.
    # The head's biases and LayerNorm affines start at zeros/ones, so every
    # proposal feature would have the norm sqrt(D) and the FPS step from the
    # empty memory's zero slot would pick among exact ties; perturb them.
    # In a Swin trunk, the biases and LayerNorm affines are perturbed too,
    # so that a bias in the wrong place shows, and the relative-position
    # bias tables are scaled from std 0.02 to 0.5, so that they move the
    # softmax.
    noise = np.random.RandomState(seed)

    def rescale(path, a):
        a = np.array(a)
        top, name = str(path[1]), str(path[-1])
        if a.ndim == 4 and not (swin and "backbone" in top):
            return a * np.float32(np.sqrt(a.shape[0] / a.shape[1]))
        if "relative_position_bias_table" in name:
            return a * np.float32(25.0)
        if a.ndim == 1 and ("head" in top or (swin and "backbone" in top)):
            return a + np.float32(0.2) * noise.randn(*a.shape).astype(np.float32)
        return a

    return model, jax.tree_util.tree_map_with_path(rescale, init(jax.random.PRNGKey(seed)))


def rel_err(got, want):
    """max |got - want| / max |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def port_model(jmodel, variables):
    """The port's CPU fp32 model with the JAX weights loaded strictly."""
    model = DiffusionDetArch(
        depth=jmodel.depth, num_classes=jmodel.num_classes, num_proposals=jmodel.num_proposals,
        num_heads=jmodel.num_heads, num_heads_local=jmodel.num_heads_local,
        res_stage=jmodel.res_stage, global_enable=jmodel.global_enable,
        local_stages=jmodel.local_stages,
        backbone_type=jmodel.backbone_type, swin_size=jmodel.swin_size, fpn_in=jmodel.fpn_in,
        compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables["params"]), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=[1, 2, "swin"],
                ids=["res_stage1", "res_stage2", "swin_t"])
def pair(request):
    if request.param == "swin":
        return jax_model_and_params(swin=True)
    return jax_model_and_params(res_stage=request.param)


def test_round_trip_leaf_for_leaf(pair):
    _, variables = pair
    tree = variables["params"]
    state = {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}
    back = convert_torch_state_dict(state)["params"]
    assert "_unmatched" not in back, back.get("_unmatched")
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert path in got, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_strict_load_and_names(pair):
    jmodel, variables = pair
    model = port_model(jmodel, variables)
    names = set(model.state_dict())
    if jmodel.backbone_type == "swin":
        for name in ("patch_embed.proj.weight", "patch_embed.norm.bias",
                     "layers.0.blocks.1.norm1.weight", "layers.2.blocks.5.norm2.bias",
                     "layers.0.blocks.0.attn.qkv.weight", "layers.3.blocks.1.attn.proj.bias",
                     "layers.1.blocks.1.attn.relative_position_bias_table",
                     "layers.1.blocks.1.attn.relative_position_index",
                     "layers.2.blocks.0.mlp.fc1.weight", "layers.3.blocks.0.mlp.fc2.bias",
                     "layers.2.downsample.reduction.weight", "layers.0.downsample.norm.weight",
                     "norm1.weight", "norm3.bias"):
            assert "backbone.bottom_up." + name in names, name
        assert not any(n.startswith(("backbone.bottom_up.norm0", "backbone.bottom_up.layers.3."
                                     "downsample")) for n in names)
        assert "backbone.fpn_lateral5.weight" in names
        index = model.state_dict()[
            "backbone.bottom_up.layers.0.blocks.0.attn.relative_position_index"]
        assert index.dtype == torch.int64 and index.shape == (49, 49)
    else:
        assert "backbone.bottom_up.stem.conv1.norm.running_var" in names
        assert "backbone.bottom_up.res5.0.shortcut.weight" in names
    assert "backbone.fpn_output3.bias" in names
    assert "head.head_series.0.inst_interact.dynamic_layer.weight" in names
    assert "head.head_series_cond.0.c_mlp.1.weight" in names
    assert "head.head_series.0.reg_module.7.bias" in names
    assert f"head.global_attention.{jmodel.res_stage - 1}.0.out_proj.weight" in names
    assert "head.time_mlp.3.weight" in names


@pytest.mark.parametrize("global_enable", [True, False], ids=["global", "no_global"])
def test_strict_load_without_conditioned_stage(global_enable):
    """Plain DiffusionDet (no conditioned stage): the JAX head never runs
    its global cross-attention, so it has no parameters for it, and the
    port builds none, whether GLOBAL.ENABLE is set or not."""
    jmodel, variables = jax_model_and_params(num_heads=2, num_heads_local=0,
                                             global_enable=global_enable)
    model = port_model(jmodel, variables)
    names = set(model.state_dict())
    assert not any(n.startswith(("head.global_attention.", "head.head_series_cond."))
                   for n in names)
    assert "head.head_series.1.inst_interact.dynamic_layer.weight" in names
