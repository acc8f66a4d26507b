"""Evaluate a model on a VID dataset with the PyTorch port.

Port of ``tools/test_net.py`` (the reference's ``tools/test_net.py:29-138``):
the model from the config with random weights from seed 0, then a
checkpoint over them; per-video inference sharded at video boundaries
(DiffusionVID streaming, or the MEGA family's ``base`` (with
``TEST.BBOX_AUG``), ``dff``, ``fgfa``, ``rdn``, ``mega`` (ResNeXt, the pixel
paths) and ``dafa`` through ``engine/inference_mega.py``); ``predictions.pkl``;
the AP50 (and motion buckets) report.

    python -m diffusionvid_torch.tools.test_net \\
        --config-file configs/vid_R_101_DiffusionVID.yaml \\
        --checkpoint OUTPUT/model_0001000.pth [MODEL.DiffusionDet.SAMPLE_STEP 4]

Under ``torchrun --nproc_per_node W -m diffusionvid_torch.tools.test_net
...`` rank r streams the videos of shard r of W, the predictions are
gathered and rank 0 writes ``predictions.pkl`` and evaluates them.

Without ``--device`` it runs on the card (``cuda:LOCAL_RANK`` under
``torchrun``) and raises when there is none; ``--device cpu`` runs the
kernels' plain versions on the CPU (over ``gloo`` under ``torchrun``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle

from ..config import load_config
from ..data import SampleConfig, get_dataset
from ..engine.inference import run_inference
from ..engine.inference_mega import run_inference_video_arch
from ..evaluation.vid_eval import eval_proposals, evaluate_vid, load_motion_iou_mat
from ..models.detectors import build_detection_model, check_supported, video_method
from ..parallel import dist
from ..utils.checkpoint import load_checkpoint
from ..utils.convert import load_jax_checkpoint, load_weights_into
from ..utils.logging import log_to_file, setup_logger
from ..utils.metrics_io import check_expected_results
from ..utils.profiling import trace


def merge_shard_predictions(output_dir: str, num_shards: int):
    """Merge the shards' tagged prediction files into global frame order.

    Each ``predictions_shard{K}of{N}.pkl`` holds [(video_index, [frame
    dicts…]), …]; video v went to shard v % N (``iter_test_videos``), so
    sorting by video index rebuilds the dataset's frame order (the
    reference's pickle all_gather merge, engine/inference.py:97-116).
    Writes ``predictions.pkl`` and returns the flat list, or None while a
    shard is missing."""
    paths = [os.path.join(output_dir, f"predictions_shard{k}of{num_shards}.pkl")
             for k in range(num_shards)]
    if not all(os.path.exists(p) for p in paths):
        return None
    tagged = []
    for p in paths:
        with open(p, "rb") as f:
            tagged.extend(pickle.load(f))
    tagged.sort(key=lambda t: t[0])
    merged = []
    for _, preds in tagged:
        merged.extend(preds)
    with open(os.path.join(output_dir, "predictions.pkl"), "wb") as f:
        pickle.dump(merged, f)
    return merged


def sample_config(cfg) -> SampleConfig:
    """The test-time chunking and resize of the config."""
    mega = cfg.MODEL.VID.MEGA
    return SampleConfig(
        num_global=mega.REF_NUM_GLOBAL,
        min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
        global_size=mega.GLOBAL.SIZE, infer_batch=cfg.INPUT.INFER_BATCH,
        shuffle_global=mega.GLOBAL.SHUFFLE)


def detector_args(cfg) -> dict:
    """``run_inference``'s detector settings from the config
    (``tools/test_net.py:188-198``)."""
    mega = cfg.MODEL.VID.MEGA
    return dict(sample_step=cfg.MODEL.DiffusionDet.SAMPLE_STEP,
                mem_size=mega.MEMORY_MANAGEMENT_SIZE_TEST,
                num_proposals=cfg.MODEL.DiffusionDet.NUM_PROPOSALS,
                stop_update_after_init=mega.GLOBAL.STOP_UPDATE_AFTER_INIT_TEST)


def video_arch_args(cfg) -> dict:
    """``run_inference_video_arch``'s settings from the config, what the
    JAX package's CLI passes (``tools/test_net.py:204-216``)."""
    aug = cfg.TEST.BBOX_AUG
    mega = cfg.MODEL.VID.MEGA
    return dict(key_frame_duration=cfg.MODEL.VID.DFF.KEY_FRAME_DURATION,
                use_bbox_aug=bool(aug.ENABLED), bbox_aug_h_flip=bool(aug.H_FLIP),
                bbox_aug_scales=tuple(aug.SCALES), bbox_aug_max_size=int(aug.MAX_SIZE),
                bbox_aug_scale_h_flip=bool(aug.SCALE_H_FLIP),
                shuffled_cur=bool(mega.SHUFFLED_CUR_TEST),
                all_frame_interval=int(mega.ALL_FRAME_INTERVAL),
                key_frame_location=int(mega.KEY_FRAME_LOCATION))


def load_motion_ious(path, logger):
    if not path or not os.path.exists(path):
        if logger:
            logger.warning(f"--motion-specific requested but motion-IoU file not found "
                           f"({path}); reporting the 'all' bucket only")
        return None
    return load_motion_iou_mat(path)


def load_weights(model, args, logger):
    """``--checkpoint``: the port's own ``model_<step>.pth`` or a JAX
    package checkpoint (``utils/convert.py: load_jax_checkpoint``), loaded
    strictly.  ``--torch-weights``: a reference weight file in any format
    of ``utils/convert.py: load_pretrained`` (a full-model ``.pth``, with or
    without a ``module.`` prefix, among them), merged over the model's
    tensors where names and shapes match, nothing skipped; a file that
    matches no tensor raises."""
    if args.checkpoint:
        state = load_jax_checkpoint(args.checkpoint)
        if state is None:
            state = load_checkpoint(args.checkpoint)["model"]
        model.load_state_dict(state, strict=True)
        logger.info(f"loaded checkpoint {args.checkpoint}")
    elif args.torch_weights:
        n = load_weights_into(model, args.torch_weights)
        logger.info(f"loaded torch weights {args.torch_weights}: {n} tensors copied")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DiffusionVID inference (PyTorch port)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="the port's model_<step>.pth (utils/checkpoint.py)")
    parser.add_argument("--torch-weights", default=None,
                        help="a reference weight file (.pth or .pkl; utils/convert.py)")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--motion-specific", action="store_true")
    parser.add_argument("--motion-iou-file", default=None,
                        help="path to vid_groundtruth_motion_iou.mat "
                             "(reference vid_eval.py:144)")
    parser.add_argument("--seq-nms", action="store_true")
    parser.add_argument("--box-only", action="store_true",
                        help="proposal-recall evaluation instead of AP "
                             "(reference MODEL.RPN_ONLY / vid_eval.py:26)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the run")
    parser.add_argument("--max-videos", type=int, default=None)
    parser.add_argument("--shard", type=int, default=0)
    parser.add_argument("--num-shards", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="default: the card, raising without one; 'cpu' for tests")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the results dict (None for a shard that
    waits on others, for a rank other than 0, or for ``--box-only``)."""
    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    output_dir = args.output_dir or os.path.join(cfg.OUTPUT_DIR, "inference")
    started = not dist.is_initialized() and dist.initialize(args.device)
    try:
        return _main(cfg, args, output_dir)
    finally:
        if started:
            dist.destroy()


def _main(cfg, args, output_dir):
    """Rank 0 copies the log to ``output_dir/log.txt``, whatever directory
    an earlier run in this process logged to."""
    logger = setup_logger()
    to_file = log_to_file(logger, output_dir) if dist.rank() == 0 else contextlib.nullcontext()
    with to_file:
        return _evaluate(cfg, args, output_dir, logger)


def _evaluate(cfg, args, output_dir, logger):
    method = video_method(cfg)
    is_diffusion = method == "diffusion" or cfg.MODEL.META_ARCHITECTURE == "DiffusionDet"
    check_supported(cfg)
    dataset_name = cfg.DATASETS.TEST[0]
    ds = get_dataset(dataset_name, is_train=False, data_dir=args.data_dir)
    if not ds.is_video:
        raise NotImplementedError(f"{dataset_name} is not a video dataset: the still-image "
                                  "evaluation is ROADMAP.md A11")
    model = build_detection_model(cfg, device=args.device)
    load_weights(model, args, logger)

    motion_ious = None
    if args.motion_specific:
        mat = args.motion_iou_file
        if mat is None and args.data_dir:
            mat = os.path.join(args.data_dir, "vid_groundtruth_motion_iou.mat")
        motion_ious = load_motion_ious(mat, logger)

    common = dict(output_dir=output_dir, use_seq_nms=args.seq_nms, motion_ious=motion_ious,
                  motion_specific=args.motion_specific, shard=args.shard,
                  num_shards=args.num_shards, logger=logger, max_videos=args.max_videos)
    with trace(args.profile_dir):
        if is_diffusion:
            predictions, gt_list, results = run_inference(
                model, ds, sample_config(cfg), **detector_args(cfg), **common)
        else:
            predictions, gt_list, results = run_inference_video_arch(
                model, ds, sample_config(cfg), method=method, **video_arch_args(cfg), **common)

    if dist.rank() != 0:
        return None     # rank 0 evaluates the gathered predictions
    if args.box_only or cfg.MODEL.RPN_ONLY:
        # proposal-recall mode (reference vid_eval.py:26-37, 85-130)
        line = f"Recall: {eval_proposals(gt_list, predictions)['recall']:.4f}"
        logger.info(line)
        with open(os.path.join(output_dir, "proposal_result.txt"), "w") as fid:
            fid.write(line)
        return None

    if args.num_shards > 1:
        # evaluate the merge once every shard has written its file
        merged = merge_shard_predictions(output_dir, args.num_shards)
        if merged is None:
            logger.info(f"shard {args.shard}/{args.num_shards} done; "
                        f"waiting on other shards for the merged eval")
            return None
        gt_all = [{"boxes": a.boxes, "labels": a.labels} for a in ds.annos]
        # the VID_val_* index files list one line per frame, so ds.annos
        # aligns with the merged predictions unless coverage is partial
        if len(gt_all) != len(merged):
            logger.warning(f"merged eval skipped: {len(gt_all)} GT entries vs "
                           f"{len(merged)} merged predictions (partial shards / "
                           f"--max-videos?)")
            return None
        results = evaluate_vid(gt_all, merged, motion_ious=motion_ious,
                               motion_specific=args.motion_specific)
        logger.info(f"merged {args.num_shards}-shard eval over {len(merged)} frames")

    if results:
        logger.info(f"FINAL AP50 = {results['ap50']:.4f}")
        if args.motion_specific and results.get("per_motion"):
            for k, v in results["per_motion"].items():
                logger.info(f"AP50 | motion={k:>6s} = {v:.4f}")
        if cfg.TEST.EXPECTED_RESULTS:
            check_expected_results({"ap50": results["ap50"]}, cfg.TEST.EXPECTED_RESULTS,
                                   cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL)
            logger.info("EXPECTED_RESULTS check passed")
    return results


if __name__ == "__main__":
    main()
