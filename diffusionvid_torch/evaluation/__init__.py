from .vid_eval import (
    MOTION_NAMES, MOTION_RANGES, calc_ap, calc_prec_rec, corloc, eval_proposals, evaluate_vid,
    load_motion_iou_mat,
)

__all__ = ["evaluate_vid", "calc_prec_rec", "calc_ap", "corloc", "eval_proposals",
           "load_motion_iou_mat", "MOTION_RANGES", "MOTION_NAMES"]
