// COCO detection matching for one image (C shared library, loaded with ctypes
// by faster_orefsdet_tpu_torch/evaluation/coco_eval.py).
//
// The per-image greedy matcher, the O(T*D*G) inner loop of the evaluation, as
// detectron2's C++ COCOeval runs it. Its results are bit-identical to the
// numpy matcher of coco_eval.py, which stays as its plain twin and oracle.
//
// Built at first use with the host's g++ by ops/_native.host_library
// ("cocoeval"): g++ -O3 -fPIC -std=c++17 -shared.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// Greedy matching for one image at T IoU thresholds.
//   dt_boxes [D,4] xyxy sorted by descending score (caller sorts/caps)
//   gt_boxes [G,4] xyxy sorted ignored-last (caller sorts)
//   gt_crowd [G], gt_ignore [G] 0/1 flags (same order)
//   thrs [T]
//   area_lo/area_hi: detection area range for unmatched-ignore marking
// Outputs (caller-allocated):
//   dt_matched [T*D] 0/1, dt_ignored [T*D] 0/1
void evaluate_image(
    const double* dt_boxes, int64_t D,
    const double* gt_boxes, int64_t G,
    const uint8_t* gt_crowd, const uint8_t* gt_ignore,
    const double* thrs, int64_t T,
    double area_lo, double area_hi,
    uint8_t* dt_matched, uint8_t* dt_ignored) {
  // IoU matrix (crowd gt: intersection over detection area)
  std::vector<double> iou(static_cast<size_t>(D) * G);
  for (int64_t d = 0; d < D; ++d) {
    const double* db = dt_boxes + d * 4;
    double da = (db[2] - db[0]) * (db[3] - db[1]);
    for (int64_t g = 0; g < G; ++g) {
      const double* gb = gt_boxes + g * 4;
      double ga = (gb[2] - gb[0]) * (gb[3] - gb[1]);
      double ix = std::min(db[2], gb[2]) - std::max(db[0], gb[0]);
      double iy = std::min(db[3], gb[3]) - std::max(db[1], gb[1]);
      double inter = std::max(ix, 0.0) * std::max(iy, 0.0);
      double uni = gt_crowd[g] ? da : da + ga - inter;
      iou[d * G + g] = uni > 0 ? inter / uni : 0.0;
    }
  }

  std::vector<int8_t> gtm(static_cast<size_t>(T) * G, 0);
  for (int64_t t = 0; t < T; ++t) {
    for (int64_t d = 0; d < D; ++d) {
      double best_iou = std::min(thrs[t], 1.0 - 1e-10);
      int64_t best = -1;
      for (int64_t g = 0; g < G; ++g) {
        if (gtm[t * G + g] && !gt_crowd[g]) continue;
        if (best > -1 && !gt_ignore[best] && gt_ignore[g]) break;
        double v = iou[d * G + g];
        if (v < best_iou) continue;
        best_iou = v;
        best = g;
      }
      if (best < 0) continue;
      dt_matched[t * D + d] = 1;
      dt_ignored[t * D + d] = gt_ignore[best];
      gtm[t * G + best] = 1;
    }
  }
  // unmatched detections outside the area range are ignored
  for (int64_t d = 0; d < D; ++d) {
    const double* db = dt_boxes + d * 4;
    double da = (db[2] - db[0]) * (db[3] - db[1]);
    bool out = da < area_lo || da > area_hi;
    if (!out) continue;
    for (int64_t t = 0; t < T; ++t) {
      if (!dt_matched[t * D + d]) dt_ignored[t * D + d] = 1;
    }
  }
}

}  // extern "C"
