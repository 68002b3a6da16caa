// Fused gather + exact-rescore kernel (C ABI, loaded via ctypes).
//
// The ids-only downlink design recomputes exact f32 distances host-side
// from a [cap, d] mirror (engine/flat.py::ids_postprocess). numpy needs a
// [b, kf, d] gathered temporary (written to DRAM, read back by einsum);
// this kernel streams each candidate row once — gather and dot fused in
// registers, with software prefetch hiding the random-access DRAM latency
// that dominates the numpy path. On the single-core build VM this is the
// serving path's host bottleneck (see PARITY "host resolution cost").
//
// Metrics:
//   0 = l2sq:   sum (q-v)^2                      (EUCLIDEAN)
//   1 = cosine: min(0.5 * sum (q-v)^2, 2.0)      (unit rows: == 1 - dot in
//       real arithmetic; the squared-difference form makes a self-match
//       distance STRUCTURALLY 0.0 in any summation order — the exactness
//       contract the service verifies)
//   2 = one_minus_dot: 1 - sum q*v               (DOT_PRODUCT)
//
// Summation uses 8 fixed partial accumulators (deterministic order,
// auto-vectorizable without -ffast-math).

#include <cstdint>

namespace {

template <int METRIC>
static inline float row_distance(const float* q, const float* v, int32_t d) {
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int32_t i = 0;
    for (; i + 8 <= d; i += 8) {
        for (int32_t l = 0; l < 8; ++l) {
            if (METRIC == 2) {
                acc[l] += q[i + l] * v[i + l];
            } else {
                float t = q[i + l] - v[i + l];
                acc[l] += t * t;
            }
        }
    }
    float tail = 0.0f;
    for (; i < d; ++i) {
        if (METRIC == 2) {
            tail += q[i] * v[i];
        } else {
            float t = q[i] - v[i];
            tail += t * t;
        }
    }
    float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
              ((acc[4] + acc[5]) + (acc[6] + acc[7])) + tail;
    if (METRIC == 0) return s;
    if (METRIC == 1) {
        s *= 0.5f;
        return s > 2.0f ? 2.0f : s;
    }
    return 1.0f - s;
}

template <int METRIC>
static void rescore_impl(const float* vecs, int64_t cap, int32_t d,
                         const int32_t* ids, const float* q, float* out,
                         int64_t b, int32_t kf) {
    const int64_t total = b * static_cast<int64_t>(kf);
    for (int64_t row = 0; row < b; ++row) {
        const float* qr = q + row * static_cast<int64_t>(d);
        const int64_t base = row * static_cast<int64_t>(kf);
        for (int32_t j = 0; j < kf; ++j) {
            const int64_t at = base + j;
            // prefetch a few candidates ahead (same row's next ids, then
            // the next row's) — the gather is DRAM-latency-bound
            const int64_t pf = at + 4;
            if (pf < total) {
                int64_t pid = ids[pf];
                if (pid < 0) pid = 0;
                if (pid >= cap) pid = cap - 1;
                __builtin_prefetch(vecs + pid * static_cast<int64_t>(d), 0, 1);
            }
            int64_t id = ids[at];
            if (id < 0) id = 0;  // masked to +inf by the caller
            if (id >= cap) id = cap - 1;
            out[at] =
                row_distance<METRIC>(qr, vecs + id * static_cast<int64_t>(d), d);
        }
    }
}

}  // namespace

extern "C" {

void rescore_f32(const float* vecs, int64_t cap, int32_t d,
                 const int32_t* ids, const float* q, float* out, int64_t b,
                 int32_t kf, int32_t metric) {
    if (metric == 0) {
        rescore_impl<0>(vecs, cap, d, ids, q, out, b, kf);
    } else if (metric == 1) {
        rescore_impl<1>(vecs, cap, d, ids, q, out, b, kf);
    } else {
        rescore_impl<2>(vecs, cap, d, ids, q, out, b, kf);
    }
}

}  // extern "C"
