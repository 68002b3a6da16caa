// Kernel 1: fused rank scan over a flat vector array.
//
// Replaces vector_store_tpu/ops/pallas_scan.py::_fused_scan (the Pallas
// kernel built by _make_kernel). For queries [nq, dp] and vectors
// [cap, dp] (cap a multiple of block_rows), candidate (blk, lane) of each
// query is the row with the smallest rank a*(q.v)+b among the rows
// blk*block_rows + lane + 128*j of row block blk. Outputs, row-major
// [nq, (cap/block_rows)*128]: the rank (f32) and the absolute row (i32).
//
// What bounds it on the H100: every (query, row) pair costs dp FMAs and
// F32 storage must stay f32, so the scan runs on the CUDA cores (67 TFLOP/s
// f32), not the tensor cores. Its intensity is B/2 op/byte for f32 rows
// (2*B*dp operations per 4*dp bytes). At the slice's shape (1M x 128 f32,
// 1024 queries) it does 2*1024*1M*128 = 262 GFLOP over 512 MB of vectors:
// 512 op/byte, above the bf16 ridge of ~295 op/byte; a batch of a few
// hundred queries (~150 op/byte at 300) sits below that ridge. Either way
// it is far above the f32 CUDA-core ridge of 20 op/byte, so on the CUDA
// cores it is compute-bound from B ~ 40 up. The grid puts the
// query tiles of one row block next to each other (blockIdx.x), so the
// 64 blocks that read the same rows run together and the rows come from
// L2 after the first read: device memory sees the vectors about once.
#include "rank_scan.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(vst::LANES)
    fused_scan_kernel(const T* __restrict__ queries,
                      const T* __restrict__ vectors,
                      const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out_rank, int* __restrict__ out_row,
                      int nq, int block_rows, int dp, int out_cols) {
  extern __shared__ float qs[];  // [QT][dp], then the row tile
  const int q0 = blockIdx.x * vst::QT;
  const int blk = blockIdx.y;
  const int nqt = min(vst::QT, nq - q0);
  vst::stage_queries(queries + (int64_t)q0 * dp, nqt, dp, qs);
  __syncthreads();
  float best[vst::QT];
  int best_row[vst::QT];
  vst::scan_rows(qs, qs + vst::QT * dp, vectors, a, b, (int64_t)blk * block_rows,
                 block_rows, dp, best, best_row);
  const int col = blk * vst::LANES + threadIdx.x;
#pragma unroll
  for (int i = 0; i < vst::QT; ++i) {
    if (i < nqt) {
      out_rank[(int64_t)(q0 + i) * out_cols + col] = best[i];
      out_row[(int64_t)(q0 + i) * out_cols + col] = best_row[i];
    }
  }
}

template <typename T>
int launch(const void* q, const void* v, const float* a, const float* b,
           float* rank, int* row, int nq, int cap, int block_rows, int dp,
           cudaStream_t stream) {
  const size_t smem = vst::smem_bytes(dp);
  cudaError_t err = vst::allow_smem(fused_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cap / block_rows;
  const dim3 grid((nq + vst::QT - 1) / vst::QT, nblk);
  fused_scan_kernel<T><<<grid, vst::LANES, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), a, b, rank, row, nq,
      block_rows, dp, nblk * vst::LANES);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vst_fused_scan(const void* queries, const void* vectors,
                              const float* a, const float* b, float* rank,
                              int* row, int nq, int cap, int block_rows,
                              int dp, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch<float>(queries, vectors, a, b, rank, row, nq, cap,
                           block_rows, dp, s);
    case vst::F16:
      return launch<__half>(queries, vectors, a, b, rank, row, nq, cap,
                            block_rows, dp, s);
    case vst::BF16:
      return launch<__nv_bfloat16>(queries, vectors, a, b, rank, row, nq, cap,
                                   block_rows, dp, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
