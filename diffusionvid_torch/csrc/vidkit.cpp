// vidkit: host-side kernels of the port's evaluation, loaded with ctypes.
//
// The per-(frame, class) greedy matching of the VID evaluator
// (mega_core/data/datasets/evaluation/vid/vid_eval.py:225-264) and the
// best-chain search of seq-NMS (seq_nms.py:85-219) run in Python in the
// reference; at ImageNet-VID scale (~176k frames x 30 classes) and at a
// video of a few hundred frames those loops dominate evaluation, so they
// run here behind a plain C ABI.  The arithmetic is the Python paths' own,
// in the same order; built without floating-point contraction, so no
// product and sum fuse into an FMA and ties break as they do in numpy.
//
// Built at first use by diffusionvid_torch/ops/_build.py: load_host
// (g++ -O3 -fPIC -shared -std=c++17 -ffp-contract=off).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// VID evaluation: per-(frame, class) greedy matching with ignore-aware
// tie-breaks.  Mirrors vid_eval.py:225-264 semantics exactly:
//   * predictions processed in descending score order (caller sorts);
//   * "integer typed boxes": +1 on far corners, then +1-pixel IoU;
//   * each pred matches the best unmatched GT with IoU >= thresh, ties
//     prefer non-ignored GTs;
//   * unmatched preds record the ignored-share discount.
//
// Outputs per prediction: match[i] in {0,1}; pred_ignore[i] in [0,1].
// ---------------------------------------------------------------------------
void vid_match_frame(const double* pred,   // [n_pred, 4] xyxy, score-sorted
                     int n_pred,
                     const double* gt,     // [n_gt, 4]
                     const double* gt_ignore,  // [n_gt] 0/1
                     int n_gt,
                     double iou_thresh,
                     double empty_weight,  // discount when n_gt == 0
                     int8_t* match,        // [n_pred] out
                     double* pred_ig) {    // [n_pred] out
  if (n_gt == 0) {
    for (int i = 0; i < n_pred; ++i) {
      match[i] = 0;
      pred_ig[i] = empty_weight;
    }
    return;
  }

  std::vector<double> gx1(n_gt), gy1(n_gt), gx2(n_gt), gy2(n_gt), garea(n_gt);
  double ig_sum = 0.0;
  for (int k = 0; k < n_gt; ++k) {
    gx1[k] = gt[k * 4 + 0];
    gy1[k] = gt[k * 4 + 1];
    gx2[k] = gt[k * 4 + 2] + 1.0;  // integer-box far-corner bump
    gy2[k] = gt[k * 4 + 3] + 1.0;
    garea[k] = (gx2[k] - gx1[k] + 1.0) * (gy2[k] - gy1[k] + 1.0);
    ig_sum += gt_ignore[k];
  }
  std::vector<char> taken(n_gt, 0);

  for (int j = 0; j < n_pred; ++j) {
    const double px1 = pred[j * 4 + 0];
    const double py1 = pred[j * 4 + 1];
    const double px2 = pred[j * 4 + 2] + 1.0;
    const double py2 = pred[j * 4 + 3] + 1.0;
    const double parea = (px2 - px1 + 1.0) * (py2 - py1 + 1.0);

    double best = iou_thresh;
    double best_ig = -1.0, best_nig = -1.0;
    int arg = -1;
    for (int k = 0; k < n_gt; ++k) {
      const double ix1 = std::max(px1, gx1[k]);
      const double iy1 = std::max(py1, gy1[k]);
      const double ix2 = std::min(px2, gx2[k]);
      const double iy2 = std::min(py2, gy2[k]);
      const double iw = std::max(0.0, ix2 - ix1 + 1.0);
      const double ih = std::max(0.0, iy2 - iy1 + 1.0);
      const double inter = iw * ih;
      const double iou = inter / (parea + garea[k] - inter);

      if (gt_ignore[k] == 1.0 && iou > best_ig) best_ig = iou;
      if (gt_ignore[k] == 0.0 && iou > best_nig) best_nig = iou;
      if (taken[k] || iou < best) continue;
      if (iou == best) {
        if (arg < 0 || gt_ignore[arg] != 0.0) arg = k;
      } else {
        arg = k;
      }
      best = iou;
    }
    if (arg >= 0) {
      match[j] = 1;
      pred_ig[j] = gt_ignore[arg];
      taken[arg] = 1;
    } else {
      match[j] = 0;
      if (best_nig > best_ig) pred_ig[j] = 0.0;
      else if (best_ig > best_nig) pred_ig[j] = 1.0;
      else pred_ig[j] = ig_sum / static_cast<double>(n_gt);
    }
  }
}

// ---------------------------------------------------------------------------
// seq-NMS: maximum-score temporal chain via DP (seq_nms.py:133-172).
//
// Boxes of one class, one video, flattened over frames.
//   offsets[f]..offsets[f+1] index frame f's boxes;
//   links: for each box, the +1-pixel-IoU >= link_thresh boxes of the next
//   frame are recomputed here (cheap relative to the repeated DP).
// Finds the best chain over alive boxes; returns its length, root frame and
// member indices (global box ids).
// ---------------------------------------------------------------------------
int vidkit_max_chain(const double* boxes,    // [n_total, 4]
                     const double* scores,   // [n_total]
                     const uint8_t* dead,    // [n_total]
                     const int32_t* offsets, // [n_frames + 1]
                     int n_frames,
                     double link_thresh,
                     double* out_total,      // chain score sum
                     int32_t* out_root,      // root frame
                     int32_t* out_path) {    // member global ids (<= n_frames)
  const int n_total = offsets[n_frames];
  std::vector<double> best(n_total, -1e30);
  std::vector<int32_t> back(n_total, -1);

  auto area = [&](int b) {
    return (boxes[b * 4 + 2] - boxes[b * 4 + 0] + 1.0) *
           (boxes[b * 4 + 3] - boxes[b * 4 + 1] + 1.0);
  };

  for (int f = 0; f < n_frames; ++f) {
    for (int b = offsets[f]; b < offsets[f + 1]; ++b) {
      if (dead[b]) continue;
      if (best[b] < scores[b]) best[b] = std::max(best[b], scores[b]);
    }
    if (f + 1 >= n_frames) break;
    for (int b = offsets[f]; b < offsets[f + 1]; ++b) {
      if (dead[b] || best[b] < -1e29) continue;
      const double a1 = area(b);
      for (int nb = offsets[f + 1]; nb < offsets[f + 2]; ++nb) {
        if (dead[nb]) continue;
        const double ix1 = std::max(boxes[b * 4 + 0], boxes[nb * 4 + 0]);
        const double iy1 = std::max(boxes[b * 4 + 1], boxes[nb * 4 + 1]);
        const double ix2 = std::min(boxes[b * 4 + 2], boxes[nb * 4 + 2]);
        const double iy2 = std::min(boxes[b * 4 + 3], boxes[nb * 4 + 3]);
        const double iw = std::max(0.0, ix2 - ix1 + 1.0);
        const double ih = std::max(0.0, iy2 - iy1 + 1.0);
        const double inter = iw * ih;
        const double iou = inter / (a1 + area(nb) - inter);
        if (iou < link_thresh) continue;
        const double cand = best[b] + scores[nb];
        if (cand > best[nb]) {
          best[nb] = cand;
          back[nb] = b;
        }
      }
    }
  }

  // global argmax over alive boxes
  int top = -1;
  double top_v = 0.0;
  for (int b = 0; b < n_total; ++b) {
    if (dead[b]) continue;
    if (best[b] > top_v) {
      top_v = best[b];
      top = b;
    }
  }
  if (top < 0) {
    *out_total = 0.0;
    *out_root = 0;
    return 0;
  }

  std::vector<int32_t> rev;
  int cur = top;
  while (cur != -1) {
    rev.push_back(cur);
    cur = back[cur];
  }
  std::reverse(rev.begin(), rev.end());
  // root frame = frame of rev[0]
  int root = 0;
  while (offsets[root + 1] <= rev[0]) ++root;
  *out_total = top_v;
  *out_root = root;
  for (size_t i = 0; i < rev.size(); ++i) out_path[i] = rev[i];
  return static_cast<int>(rev.size());
}

}  // extern "C"
