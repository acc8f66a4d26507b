"""Data parallelism over ``torch.distributed``: 2 ``gloo`` ranks on the CPU.

One spawn of 2 rank processes (``test_torch_port_ddp_ranks.py``, joined as
``torchrun`` would join them) runs three jobs while this process computes
the references:

  * one DDP optimizer step of the tiny model of ``test_torch_port_train.py``
    with ACCUMULATION_STEPS 2: micro-step m of rank r trains on sample r of
    the 2-sample batch m.  The JAX package's train step on batch m is the
    gradient of the mean of its 2 samples' losses (on a mesh of 2 devices
    its psum computes the same mean, so one device stands for the mesh);
    the optimizer step's gradient is the mean of the two micro-batches'
    (``optax.MultiSteps``).  The logged losses to 1e-4 relative, the
    gradient that reaches the update within 1e-3 of its norm, equal on both
    ranks, and no all-reduce in the first micro-step;
  * ``run_inference`` with the ranks as the shards, gathered, against the
    single-process run, with the JAX package's draws handed to each video:
    equal predictions and AP50, ``predictions.pkl`` from rank 0 alone;
  * the same DDP optimizer step of the local-attention model of
    ``test_torch_port_local_attn.py`` (STAGE 2 without the global
    attention: stage 0's local parameters take no gradient, so the wrapper
    runs with ``find_unused_parameters``) against that file's JAX train
    step, at the same tolerances; the idle parameters get a zero gradient
    and move by the weight decay alone, equally on both ranks;
  * the train CLI for 2 iterations, then resumed to 3: one checkpoint
    writer, rank 0, and the resumed run starting at iteration 2;
  * the train CLI validating every iteration while rank 1's validation
    raises before the gather: both ranks warn at the first validation and
    raise at the second, rank 1 its own error and rank 0 ``RankFailed``.

Then the rank-seed departure of the train CLI, without processes.
"""

import pickle
import socket

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from diffusionvid_tpu.engine import train as jt
from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch

from diffusionvid_torch.data import SampleConfig, VIDDataset
from diffusionvid_torch.engine import inference
from diffusionvid_torch.engine import train as tt
from diffusionvid_torch.engine.streaming import StreamingDetector
from diffusionvid_torch.ops import _build
from diffusionvid_torch.parallel import dist
from diffusionvid_torch.tools import train_net
from diffusionvid_torch.utils.checkpoint import load_checkpoint
from diffusionvid_torch.utils.convert import state_dict_from_jax
from diffusionvid_torch.utils.device import resolve_device
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_inference import RUN, SCFG, jax_draws
from test_torch_port_train import ARCH, CFG_UNIFORM, NUM_GLOBAL, _batch, _jax_draws, _jax_params
from test_torch_port_train import _port_model
from test_torch_port_train_cli import CONFIG, TINY, tree  # noqa: F401  (the shared fixture)
from test_torch_port_weights import one_thread, rel_err  # noqa: F401
from test_torch_port_ddp_ranks import run_rank
import test_torch_port_local_attn as la

WORLD = 2



def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inference_model():
    gen = torch.Generator().manual_seed(4)
    arch = dict(depth=18, num_classes=30, num_proposals=RUN["num_proposals"], num_heads=1,
                num_heads_local=1)
    from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
    model = DiffusionDetArch(**arch, compute_dtype=torch.float32)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.mul_((p.shape[0] / p.shape[1]) ** 0.5)
            elif p.dim() == 1 and name.startswith("head."):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model.eval(), arch


def _video_draws():
    """JAX's draws of the 2 videos, split by video (3 a video at x1)."""
    flat = jax_draws(2)
    return [flat[:3], flat[3:]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, mini_vid, tree):  # noqa: F811
    """Spawn the 2 ranks, compute the references meanwhile, join."""
    work = tmp_path_factory.mktemp("ddp")
    model = _port_model()
    micro = []
    for m in range(2):
        arrays = _batch(m)
        batch = tt.TrainBatch(*[torch.from_numpy(np.array(a)) for a in arrays])
        micro.append((tt.TrainBatch(batch.images, batch.gt_boxes, batch.gt_labels.long(),
                                    batch.gt_valid, batch.whwh),
                      _jax_draws(jax.random.PRNGKey(5 + m))))
    local_model, local_arch = la._train_model(2, False)
    local_micro = [(la._port_batch(la._batch(m)), la._draws(jax.random.PRNGKey(5 + m)))
                   for m in range(2)]
    inf_model, inf_arch = _inference_model()
    dataset = ("test_set", mini_vid["root"], mini_vid["img_dir"], mini_vid["anno_dir"],
               mini_vid["index"])
    spec = {"out": str(work),
            "train_step": {"arch": ARCH, "state": model.state_dict(), "micro": micro,
                           "num_global": NUM_GLOBAL},
            "train_step_local": {"arch": local_arch, "state": local_model.state_dict(),
                                 "micro": local_micro, "num_global": la.NUM_GLOBAL},
            "inference": {"arch": inf_arch, "state": inf_model.state_dict(),
                          "dataset": dataset, "draws": _video_draws(), "scfg": SCFG,
                          "run": RUN, "output_dir": str(work / "gathered")},
            "cli": {"argv": ["--config-file", CONFIG, "--data-dir", str(tree), "--device", "cpu",
                             "--seed", "3", *TINY, "OUTPUT_DIR", str(work / "cli")]},
            "val_failure": {"argv": ["--config-file", CONFIG, "--data-dir", str(tree),
                                     "--device", "cpu", *TINY, "SOLVER.TEST_PERIOD", "1",
                                     "SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "0",
                                     "OUTPUT_DIR", str(work / "val_failure")]}}
    spec_path = work / "spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    ctx = mp.start_processes(run_rank, args=(WORLD, _free_port(), str(spec_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        refs = {"jax_step": _jax_step(model), "single": _single_inference(inf_model, dataset),
                "jax_local": [la.jax_train_step(m) for m in range(2)]}
    finally:
        while not ctx.join():
            pass
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return dict(work=work, model=model, local_model=local_model, out=out, **refs)


def _jax_step(model):
    """The JAX train step's losses and gradient on each 2-sample batch, and
    the optimizer step's gradient: their mean."""
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: CFG_UNIFORM)
        params = _jax_params(model)
        loss_fn = jt.make_loss_fn(JaxArch(**ARCH), NUM_GLOBAL)
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        totals, grads = [], []
        for m in range(2):
            batch = jt.TrainBatch(*[np.asarray(a) for a in _batch(m)])
            (total, losses), g = vg(params, batch, jax.random.PRNGKey(5 + m))
            totals.append({"total_loss": float(total), **{k: float(v) for k, v in losses.items()}})
            grads.append(state_dict_from_jax(g))
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    return {"losses": totals, "grad": mean}


def _single_inference(model, dataset):
    """The single-process run with the same handed draws."""
    queue = [np.array(d) for video in _video_draws() for d in video]
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(StreamingDetector, "noise",
                    lambda self, state, shape: torch.from_numpy(queue.pop(0)).reshape(shape))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            preds, gts, results = inference.run_inference(
                model, VIDDataset(*dataset, is_train=False, use_cache=False),
                SampleConfig(**SCFG), use_seq_nms=True, **RUN)
        finally:
            torch.set_num_threads(threads)
    assert not queue
    return {"predictions": preds, "gts": gts, "results": results}


def test_ddp_step_equals_jax_step(ranks):
    want = ranks["jax_step"]
    for out in ranks["out"]:
        step = out["train_step"]
        assert step["count"] == 1 and step["reduces"][0] == 0 and step["reduces"][1] > 0
        assert not step["find_unused"]
        for got, w in zip(step["metrics"], want["losses"]):
            assert sorted(got) == sorted(w)
            for k, v in w.items():
                assert abs(got[k] - v) <= 1e-4 * abs(v), k
        assert set(step["grads"]) == set(want["grad"])
        for name, w in want["grad"].items():
            g = step["grads"][name]
            wn = float(torch.linalg.vector_norm(w))
            assert float(torch.linalg.vector_norm(g - w)) <= 1e-3 * max(wn, 1e-8), name
    a, b = (out["train_step"] for out in ranks["out"])
    for name in a["grads"]:
        assert torch.equal(a["grads"][name], b["grads"][name]), name
        assert torch.equal(a["params"][name], b["params"][name]), name
    moved = sum(not torch.equal(a["params"][n], p.detach())
                for n, p in ranks["model"].named_parameters())
    assert moved > 0


def test_ddp_step_with_idle_local_stages_equals_jax_step(ranks):
    """Stage 0's local parameters take no gradient (its output is
    overwritten by stage 1's): the wrapper finds them unused, their
    gradient at the update is zero, as JAX's, and AdamW moves them by its
    decoupled weight decay alone (lr 1e-4 x decay 1e-4, the defaults)."""
    want = ranks["jax_local"]
    idle = set(tt.unused_in_training(ranks["local_model"]))
    assert idle and all(n.startswith(("head.local_attention.0.", "head.local_norm.0."))
                        for n in idle)
    start = dict(ranks["local_model"].named_parameters())
    for out in ranks["out"]:
        step = out["train_step_local"]
        assert step["find_unused"] and step["count"] == 1
        assert step["reduces"][0] == 0 and step["reduces"][1] > 0
        for got, w in zip(step["metrics"], want):
            assert sorted(got) == sorted(["total_loss", *w["losses"]])
            assert abs(got["total_loss"] - w["total_loss"]) <= 1e-4 * abs(w["total_loss"])
            for k, v in w["losses"].items():
                assert abs(got[k] - v) <= 1e-4 * abs(v), k
        mean = {k: (want[0]["grads"][k] + want[1]["grads"][k]) / 2 for k in want[0]["grads"]}
        assert set(step["grads"]) == set(mean)
        for name, w in mean.items():
            g = step["grads"][name]
            if name in idle:
                assert not g.any() and not w.any(), name
                decayed = start[name].detach().clone().mul_(1 - 1e-4 * 1e-4)
                assert torch.equal(step["params"][name], decayed), name
                continue
            wn = float(torch.linalg.vector_norm(w))
            assert float(torch.linalg.vector_norm(g - w)) <= 1e-3 * max(wn, 1e-8), name
    a, b = (out["train_step_local"] for out in ranks["out"])
    for name in a["grads"]:
        assert torch.equal(a["grads"][name], b["grads"][name]), name
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_gathered_inference_equals_single_process(ranks):
    want = ranks["single"]
    r0, r1 = (out["inference"] for out in ranks["out"])
    assert sorted(r0["videos"] + r1["videos"]) == [0, 1] and r0["left"] == r1["left"] == 0
    for out in (r0, r1):            # every rank holds the merged predictions
        assert len(out["predictions"]) == len(want["predictions"]) == 12
        for g, w in zip(out["predictions"], want["predictions"]):
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(g[k], w[k])
        assert [len(g["boxes"]) for g in out["gts"]] == [len(g["boxes"]) for g in want["gts"]]
    assert r1["results"] is None
    assert r0["results"]["ap50"] == want["results"]["ap50"] or (
        np.isnan(r0["results"]["ap50"]) and np.isnan(want["results"]["ap50"]))
    saved = sorted(p.name for p in (ranks["work"] / "gathered").iterdir())
    assert saved == ["predictions.pkl", "result.txt"]
    with open(ranks["work"] / "gathered" / "predictions.pkl", "rb") as f:
        assert len(pickle.load(f)) == 12


def test_train_cli_two_ranks_one_writer_and_resume(ranks):
    out_dir = ranks["work"] / "cli"
    r0, r1 = (out["cli"] for out in ranks["out"])
    assert r0["writers"] == [(0, 2), (0, 3)] and r1["writers"] == []
    assert sorted(p.name for p in out_dir.glob("model_*.pth")) == ["model_0000002.pth",
                                                                   "model_0000003.pth"]
    assert (out_dir / "config.yml").exists() and (out_dir / "log.txt").exists()
    log = (out_dir / "log.txt").read_text()
    assert "data-parallel ranks: 2" in log
    for run in ("first", "resumed"):
        assert r0[run]["metrics"] == r1[run]["metrics"]      # all-reduced means
    assert r0["first"]["start_iter"] == 0 and r0["resumed"]["start_iter"] == 2
    assert load_checkpoint(str(out_dir / "model_0000003.pth"))["step"] == 3


def test_validation_failure_on_one_rank_fails_every_rank(ranks):
    """Rank 1's validation raises before ``run_inference`` gathers: no rank
    waits in a collective, both count the failure, warn at the first and
    raise at the second validation (iteration 2 of 4)."""
    r0, r1 = (out["val_failure"] for out in ranks["out"])
    assert r1["raised"] == "RuntimeError" and "injected" in r1["message"], r1
    assert r0["raised"] == "RankFailed" and "rank 1" in r0["message"], r0
    assert r0["validations"] == r1["validations"] == 2
    log = (ranks["work"] / "val_failure" / "log.txt").read_text()
    assert "periodic validation failed (1/2)" in log
    assert not list((ranks["work"] / "val_failure").glob("model_*.pth"))


def test_rank_seeds_and_draws():
    """Rank 0's sample seed is the JAX CLI's and rank 1's differs; rank r
    takes the r-th of the reuse swap's draws, as the JAX CLI's sample r
    does; the iteration's train draws are drawn for the W samples, so rank
    0's timesteps, noise and placeholders are the one-rank run's."""
    for it in (0, 5, 12345):
        assert train_net.sample_seed(it) == (1000003 * it + 12345) % (2 ** 31 - 1)
        assert train_net.sample_seed(it, 1) != train_net.sample_seed(it)
    frames = 5

    def samples(n):
        return [{k: np.arange(frames)[:, None] * np.ones((1, 2)) + s
                 for k in ("images", "gt_boxes", "gt_labels", "gt_valid")} for s in range(n)]

    joint = samples(WORLD)
    train_net.reuse_swap(joint, 7, 3)
    for r in range(WORLD):
        mine = [samples(WORLD)[r]]
        train_net.reuse_swap(mine, 7, 3, rank=r)
        np.testing.assert_array_equal(mine[0]["images"], joint[r]["images"])
    both = tt.draw_train_randoms(tt.iteration_generator(3, 7), WORLD, frames, 10)
    one = tt.draw_train_randoms(tt.iteration_generator(3, 7), 1, frames, 10)
    for a, b in zip(both[:3], one[:3]):
        assert torch.equal(a[:1], b)
    assert both.null.shape == (WORLD, frames)


def test_group_helpers_without_a_group(monkeypatch):
    """Without the torchrun environment nothing starts and the helpers
    answer for one process; under a group the card is cuda:LOCAL_RANK."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize("cpu") is False
    assert (dist.rank(), dist.world_size()) == (0, 1)
    tagged = [(1, ["b0", "b1"]), (0, ["a0"])]
    assert dist.gather_predictions(tagged) == ["a0", "b0", "b1"]
    assert dist.all_reduce_mean({"x": torch.tensor(2.0)})["x"] == 2.0
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 3)


def test_launch_on_a_card_that_is_not_current_raises(monkeypatch):
    """The kernels launch through ctypes on the current device with the
    stream of the tensor's device: a tensor on another card raises."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        _build.stream_ptr(torch.device("cuda", 1))
