// Kernel 2: grouped rank scan over the IVF engine's cluster-major region,
// with g clusters per block (kernel 4).
//
// Replaces vector_store_tpu/ops/ivf.py::_grouped_scan (the Pallas kernel
// built by _make_grouped_kernel, which also scans i8 storage) and
// scripts/ivf_stage_opt2.py::_grouped_scan_g (the same body with g
// clusters per grid step). Cluster c owns stored rows [c*cmax, (c+1)*cmax)
// and query slots [c*s, (c+1)*s) of queries_grouped (the regrouped
// (query, cluster) pairs). For each slot, candidate `lane` is the row with
// the smallest rank a*(q.v)+b among the cluster's rows c*cmax + lane +
// 128*j. Outputs, row-major [nlist*s, 128]: the rank (f32) and the
// absolute row (i32, c*cmax + offset).
//
// Block (x, y) takes query tile x of clusters y*g .. y*g+g-1, one after
// the other; g = 1 is one cluster per block. On the TPU a grid step had a
// fixed cost that g amortised; here blocks run in parallel and g only
// trades the block count against the work of each block (measured on the
// H100: PERF.md, and ops/ivf.py::choose_g).
//
// Storage types: F32/F16/BF16 rows with queries of the same type, or int8
// rows (the I8 index, v = round(127 v')) scanned by true-scale bf16
// queries with the 127x scale folded into (a, b) by the engine; an int8 x
// bf16 product is exact in f32, as the TPU kernel's cast to bf16 was.
//
// What bounds it on the H100: at the global smoke's shape (nlist 2048,
// cmax 768, s 32, dp 128 f32) it does 2*2048*32*768*128 = 12.9 GFLOP over
// 805 MB of cluster-major vectors, ~16 op/byte: below the f32 CUDA-core
// ridge of 20 op/byte, so the scan is bound by device memory (~0.24 ms at
// 3.35 TB/s) and the tiles of one cluster share its rows through L1/L2.
// The design keeps the one pass over each cluster's rows: the s/16 query
// tiles of a cluster are neighbouring blocks (blockIdx.x), so the second
// tile finds the rows in L2.
#include "rank_scan.cuh"

namespace {

template <typename TQ, typename TV>
__global__ void __launch_bounds__(vst::LANES)
    grouped_scan_kernel(const TQ* __restrict__ queries_grouped,
                        const TV* __restrict__ vectors,
                        const float* __restrict__ a,
                        const float* __restrict__ b,
                        float* __restrict__ out_rank, int* __restrict__ out_row,
                        int s, int cmax, int dp, int g) {
  extern __shared__ float qs[];  // [QT][dp], then the row tile
  const int t0 = blockIdx.x * vst::QT;  // first slot of this tile
  const int nqt = min(vst::QT, s - t0);
  for (int gi = 0; gi < g; ++gi) {
    const int c = blockIdx.y * g + gi;
    const int64_t q0 = (int64_t)c * s + t0;
    if (gi) __syncthreads();  // the previous cluster's query tile is consumed
    vst::stage_queries(queries_grouped + q0 * dp, nqt, dp, qs);
    __syncthreads();
    float best[vst::QT];
    int best_row[vst::QT];
    vst::scan_rows(qs, qs + vst::QT * dp, vectors, a, b, (int64_t)c * cmax,
                   cmax, dp, best, best_row);
#pragma unroll
    for (int i = 0; i < vst::QT; ++i) {
      if (i < nqt) {
        out_rank[(q0 + i) * vst::LANES + threadIdx.x] = best[i];
        out_row[(q0 + i) * vst::LANES + threadIdx.x] = best_row[i];
      }
    }
  }
}

template <typename TQ, typename TV>
int launch(const void* qg, const void* v, const float* a, const float* b,
           float* rank, int* row, int nlist, int s, int cmax, int dp, int g,
           cudaStream_t stream) {
  if (g < 1 || nlist % g) return (int)cudaErrorInvalidValue;
  const size_t smem = vst::smem_bytes(dp);
  cudaError_t err = vst::allow_smem(grouped_scan_kernel<TQ, TV>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + vst::QT - 1) / vst::QT, nlist / g);
  grouped_scan_kernel<TQ, TV><<<grid, vst::LANES, smem, stream>>>(
      static_cast<const TQ*>(qg), static_cast<const TV*>(v), a, b, rank, row,
      s, cmax, dp, g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: the storage type (vst::DType); queries share it, except for I8
// storage, whose queries are bf16.
extern "C" int vst_grouped_scan(const void* queries_grouped,
                                const void* vectors, const float* a,
                                const float* b, float* rank, int* row,
                                int nlist, int s, int cmax, int dp, int dtype,
                                int g, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch<float, float>(queries_grouped, vectors, a, b, rank, row,
                                  nlist, s, cmax, dp, g, st);
    case vst::F16:
      return launch<__half, __half>(queries_grouped, vectors, a, b, rank, row,
                                    nlist, s, cmax, dp, g, st);
    case vst::BF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          queries_grouped, vectors, a, b, rank, row, nlist, s, cmax, dp, g, st);
    case vst::I8:
      return launch<__nv_bfloat16, int8_t>(queries_grouped, vectors, a, b,
                                           rank, row, nlist, s, cmax, dp, g,
                                           st);
  }
  return (int)cudaErrorInvalidValue;
}
