// Greedy COCO-style detection <-> GT matching for the Omni3D evaluator
// (weakcube_tpu/csrc/eval_match.cpp): the per-(image, category, threshold)
// assignment, the evaluator's one Python-level hot loop.
//
// Host C++, built with g++ at first use and loaded with ctypes by
// evaluation/_native.py. Semantics are those of
// evaluation/omni3d_eval.py::_match_image_plain:
//   * detections visited in descending score order (the caller sorts);
//   * real GTs tried before ignored ones; a detection matched to a real GT
//     never moves to an ignored one;
//   * unmatched detections take dt_ignore (proximity and depth-band ignores).

#include <cstdint>
#include <vector>

extern "C" {

// dt_order:   (D)      detection indices in descending score order
// iou:        (D, G)   row-major IoU matrix
// gt_ignore:  (G)      0/1
// dt_ignore:  (D)      0/1
// thrs:       (T)      IoU thresholds
// out_match:  (T, D)   matched GT index or -1
// out_ignore: (T, D)   0/1
void greedy_match(const int64_t* dt_order, int64_t D,
                  const double* iou, int64_t G,
                  const uint8_t* gt_ignore,
                  const uint8_t* dt_ignore,
                  const double* thrs, int64_t T,
                  int64_t* out_match, uint8_t* out_ignore) {
    // GT visit order: real GTs first, stable
    std::vector<int64_t> g_order;
    g_order.reserve(G);
    for (int64_t g = 0; g < G; ++g) if (!gt_ignore[g]) g_order.push_back(g);
    for (int64_t g = 0; g < G; ++g) if (gt_ignore[g]) g_order.push_back(g);
    std::vector<uint8_t> taken(G);

    for (int64_t t = 0; t < T; ++t) {
        for (int64_t g = 0; g < G; ++g) taken[g] = 0;
        const double thr_floor = thrs[t] < (1.0 - 1e-10) ? thrs[t] : (1.0 - 1e-10);
        for (int64_t oi = 0; oi < D; ++oi) {
            const int64_t d = dt_order[oi];
            int64_t best = -1;
            double best_iou = thr_floor;
            for (int64_t k = 0; k < G; ++k) {
                const int64_t g = g_order[k];
                if (taken[g] && !gt_ignore[g]) continue;
                if (best > -1 && !gt_ignore[best] && gt_ignore[g]) break;
                const double v = iou[d * G + g];
                if (v < best_iou) continue;
                best_iou = v;
                best = g;
            }
            if (best >= 0) {
                taken[best] = 1;
                out_match[t * D + d] = best;
                out_ignore[t * D + d] = gt_ignore[best];
            } else {
                out_match[t * D + d] = -1;
                out_ignore[t * D + d] = dt_ignore[d];
            }
        }
    }
}

}  // extern "C"
