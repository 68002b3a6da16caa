// Kernel 2: grouped rank scan over the IVF engine's cluster-major region.
//
// Replaces vector_store_tpu/ops/ivf.py::_grouped_scan (the Pallas kernel
// built by _make_grouped_kernel). Cluster c owns stored rows
// [c*cmax, (c+1)*cmax) and query slots [c*s, (c+1)*s) of queries_grouped
// (the regrouped (query, cluster) pairs). For each slot, candidate `lane`
// is the row with the smallest rank a*(q.v)+b among the cluster's rows
// c*cmax + lane + 128*j. Outputs, row-major [nlist*s, 128]: the rank (f32)
// and the absolute row (i32, c*cmax + offset).
//
// What bounds it on the H100: at the slice's shape (nlist 2048, cmax 768,
// s 32, dp 128 f32) it does 2*2048*32*768*128 = 12.9 GFLOP over 805 MB
// of cluster-major vectors, ~16 op/byte: below the f32 CUDA-core ridge of
// 20 op/byte, so the scan is bound by device memory (~0.24 ms at
// 3.35 TB/s) and the tiles of one cluster share its rows through L1/L2.
// The design keeps the one pass over each cluster's rows: the s/16 query
// tiles of a cluster are neighbouring blocks (blockIdx.x), so the second
// tile finds the rows in L2.
#include "rank_scan.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(vst::LANES)
    grouped_scan_kernel(const T* __restrict__ queries_grouped,
                        const T* __restrict__ vectors,
                        const float* __restrict__ a,
                        const float* __restrict__ b,
                        float* __restrict__ out_rank, int* __restrict__ out_row,
                        int s, int cmax, int dp) {
  extern __shared__ float qs[];  // [QT][dp], then the row tile
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * vst::QT;  // first slot of this tile
  const int nqt = min(vst::QT, s - t0);
  const int64_t q0 = (int64_t)c * s + t0;
  vst::stage_queries(queries_grouped + q0 * dp, nqt, dp, qs);
  __syncthreads();
  float best[vst::QT];
  int best_row[vst::QT];
  vst::scan_rows(qs, qs + vst::QT * dp, vectors, a, b, (int64_t)c * cmax, cmax,
                 dp, best, best_row);
#pragma unroll
  for (int i = 0; i < vst::QT; ++i) {
    if (i < nqt) {
      out_rank[(q0 + i) * vst::LANES + threadIdx.x] = best[i];
      out_row[(q0 + i) * vst::LANES + threadIdx.x] = best_row[i];
    }
  }
}

template <typename T>
int launch(const void* qg, const void* v, const float* a, const float* b,
           float* rank, int* row, int nlist, int s, int cmax, int dp,
           cudaStream_t stream) {
  const size_t smem = vst::smem_bytes(dp);
  cudaError_t err = vst::allow_smem(grouped_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + vst::QT - 1) / vst::QT, nlist);
  grouped_scan_kernel<T><<<grid, vst::LANES, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(v), a, b, rank, row, s,
      cmax, dp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vst_grouped_scan(const void* queries_grouped,
                                const void* vectors, const float* a,
                                const float* b, float* rank, int* row,
                                int nlist, int s, int cmax, int dp, int dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch<float>(queries_grouped, vectors, a, b, rank, row, nlist, s,
                           cmax, dp, st);
    case vst::F16:
      return launch<__half>(queries_grouped, vectors, a, b, rank, row, nlist,
                            s, cmax, dp, st);
    case vst::BF16:
      return launch<__nv_bfloat16>(queries_grouped, vectors, a, b, rank, row,
                                   nlist, s, cmax, dp, st);
  }
  return (int)cudaErrorInvalidValue;
}
