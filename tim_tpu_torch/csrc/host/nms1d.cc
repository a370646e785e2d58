// 1-D temporal NMS / Soft-NMS, C API for ctypes.
//
// tim_tpu_torch's own copy of cpp/nms1d.cc (the port shares no code with
// the JAX package); evals/nms.py builds it with g++ into
// tim_tpu_torch/build/ at first use. Keep its code equal to that file's.
//
// Native replacement for the reference's torch extension
// (detection/eval_detection/csrc/nms_cpu.cpp): greedy IoU suppression and
// Soft-NMS (linear/gaussian decay) over [start, end] segments. Semantics
// match the reference exactly (epsilon'd lengths, >= threshold suppression,
// in-place swap compaction for soft-NMS) so detection mAP is reproducible;
// the implementation below is written fresh around a single Seg record
// instead of parallel raw arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Seg {
  float start;
  float end;
  float score;
  float len;       // end - start + 1e-6 (reference-compatible epsilon)
  int64_t index;   // original position
};

inline float overlap(const Seg& a, const Seg& b) {
  const float lo = std::max(a.start, b.start);
  const float hi = std::min(a.end, b.end);
  const float inter = std::max(0.0f, hi - lo);
  return inter / (a.len + b.len - inter);
}

// Core Soft-NMS over s[0..count): argmax-select (first max wins ties, same
// as the single-class entry point), decay, swap-with-last compaction.
// Emits (start, end, score) triplets + original indices at the given output
// cursors; returns the survivor count.
int64_t softnms_core(std::vector<Seg>& s, int64_t count, float iou_threshold,
                     float sigma, float min_score, int method,
                     float* dets_out, int64_t* inds_out) {
  for (int64_t i = 0; i < count; ++i) {
    int64_t best = i;
    for (int64_t j = i + 1; j < count; ++j) {
      if (s[j].score > s[best].score) best = j;
    }
    std::swap(s[i], s[best]);

    dets_out[3 * i + 0] = s[i].start;
    dets_out[3 * i + 1] = s[i].end;
    dets_out[3 * i + 2] = s[i].score;
    inds_out[i] = s[i].index;

    for (int64_t j = i + 1; j < count; ++j) {
      const float ovr = overlap(s[i], s[j]);
      float weight = 1.0f;
      if (method == 0) {
        if (ovr >= iou_threshold) weight = 0.0f;
      } else if (method == 1) {
        if (ovr >= iou_threshold) weight = 1.0f - ovr;
      } else if (method == 2) {
        weight = std::exp(-(ovr * ovr) / sigma);
      }
      s[j].score *= weight;
      if (s[j].score < min_score) {
        s[j] = s[count - 1];
        --count;
        --j;
      }
    }
  }
  return count;
}

}  // namespace

extern "C" {

// Greedy NMS. keep_out must hold n entries; returns the kept count.
// Kept indices are emitted in descending-score order.
int64_t nms_1d(const float* segs, const float* scores, int64_t n,
               float iou_threshold, int64_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<Seg> s(n);
  for (int64_t i = 0; i < n; ++i) {
    s[i] = {segs[2 * i], segs[2 * i + 1], scores[i],
            segs[2 * i + 1] - segs[2 * i] + 1e-6f, i};
  }
  std::stable_sort(s.begin(), s.end(), [](const Seg& a, const Seg& b) {
    return a.score > b.score;
  });

  std::vector<char> alive(n, 1);
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!alive[i]) continue;
    keep_out[kept++] = s[i].index;
    for (int64_t j = i + 1; j < n; ++j) {
      if (alive[j] && overlap(s[i], s[j]) >= iou_threshold) alive[j] = 0;
    }
  }
  return kept;
}

// Soft-NMS. dets_out: [n, 3] (start, end, decayed score) in processed
// order; inds_out: original indices of survivors. Returns survivor count.
// method: 0 = hard, 1 = linear decay, 2 = gaussian decay.
int64_t softnms_1d(const float* segs, const float* scores, int64_t n,
                   float iou_threshold, float sigma, float min_score,
                   int method, float* dets_out, int64_t* inds_out) {
  if (n <= 0) return 0;
  std::vector<Seg> s(n);
  for (int64_t i = 0; i < n; ++i) {
    s[i] = {segs[2 * i], segs[2 * i + 1], scores[i],
            segs[2 * i + 1] - segs[2 * i] + 1e-6f, i};
  }
  return softnms_core(s, n, iou_threshold, sigma, min_score, method,
                      dets_out, inds_out);
}

// Multi-class Soft-NMS in ONE call: groups rows by cls (ascending class,
// original row order within a class — identical subsets to the per-class
// Python loop it replaces) and runs softnms_core per group. Outputs are
// concatenated in ascending-class order: dets_out [n, 3], cls_out /
// inds_out [n]. Returns the total survivor count. The caller applies the
// final global score sort (matching eval_detection/nms.py:171-181).
int64_t softnms_1d_multiclass(const float* segs, const float* scores,
                              const int64_t* cls, int64_t n,
                              float iou_threshold, float sigma,
                              float min_score, int method, float* dets_out,
                              int64_t* cls_out, int64_t* inds_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [cls](int64_t a, int64_t b) {
    return cls[a] < cls[b];
  });

  std::vector<Seg> group;
  group.reserve(64);
  int64_t total = 0;
  int64_t g0 = 0;
  while (g0 < n) {
    int64_t g1 = g0;
    const int64_t c = cls[order[g0]];
    while (g1 < n && cls[order[g1]] == c) ++g1;

    group.clear();
    for (int64_t k = g0; k < g1; ++k) {
      const int64_t i = order[k];
      group.push_back({segs[2 * i], segs[2 * i + 1], scores[i],
                       segs[2 * i + 1] - segs[2 * i] + 1e-6f, i});
    }
    const int64_t kept =
        softnms_core(group, g1 - g0, iou_threshold, sigma, min_score, method,
                     dets_out + 3 * total, inds_out + total);
    for (int64_t k = 0; k < kept; ++k) cls_out[total + k] = c;
    total += kept;
    g0 = g1;
  }
  return total;
}

}  // extern "C"
