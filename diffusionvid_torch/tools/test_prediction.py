"""Re-evaluate saved predictions without a model.

Port of ``tools/test_prediction.py`` (the reference's
``tools/test_prediction.py:23-87``, ``inference_no_model``):

    python -m diffusionvid_torch.tools.test_prediction \\
        --config-file configs/vid_R_101_DiffusionVID.yaml \\
        --predictions OUTPUT/inference/predictions.pkl [--motion-specific]
"""

from __future__ import annotations

import argparse

from ..config import load_config
from ..data import get_dataset
from ..engine.inference import inference_no_model
from ..evaluation.vid_eval import load_motion_iou_mat
from ..utils.logging import setup_logger
from ..utils.metrics_io import check_expected_results


def main(argv=None):
    """Returns the results dict of ``evaluate_vid``."""
    parser = argparse.ArgumentParser(description="re-evaluate saved predictions")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--predictions", required=True)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--motion-iou-file", default=None)
    parser.add_argument("--motion-specific", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = load_config(args.config_file, args.opts)
    logger = setup_logger()
    ds = get_dataset(cfg.DATASETS.TEST[0], is_train=False, data_dir=args.data_dir)
    motion = load_motion_iou_mat(args.motion_iou_file) if args.motion_iou_file else None
    results = inference_no_model(args.predictions, ds, motion_ious=motion,
                                 motion_specific=args.motion_specific)
    logger.info(f"AP50 = {results['ap50']:.4f}")
    for k, v in results["per_motion"].items():
        logger.info(f"AP50 | motion={k:>6s} = {v:.4f}")
    if cfg.TEST.EXPECTED_RESULTS:
        check_expected_results({"ap50": results["ap50"]}, cfg.TEST.EXPECTED_RESULTS,
                               cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL)
        logger.info("EXPECTED_RESULTS check passed")
    return results


if __name__ == "__main__":
    main()
