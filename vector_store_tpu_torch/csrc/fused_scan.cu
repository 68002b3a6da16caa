// Kernel 1: fused rank scan over a flat vector array.
//
// Replaces vector_store_tpu/ops/pallas_scan.py::_fused_scan (the Pallas
// kernel built by _make_kernel). For queries [nq, dp] and vectors
// [cap, dp] (cap a multiple of block_rows), candidate (blk, lane) of each
// query is the row with the smallest rank a*(q.v)+b among the rows
// blk*block_rows + lane + 128*j of row block blk. Outputs, row-major
// [nq, (cap/block_rows)*128]: the rank (f32) and the absolute row (i32).
//
// What bounds it on the H100: its operations. Every (query, row) pair
// costs dp multiply-adds and every row is used by all nq queries: 2*nq/4
// operations per byte of an F32 row, nq per byte of a 16-bit row. At the
// flat-scan shape (1,015,808 x 128 rows, 1024 queries: 266 GFLOP) that is
// 512 op/byte in F32, far above the CUDA cores' ridge of 20 (67 TFLOP/s
// over 3.35 TB/s): about 4 ms of f32 FMAs against 0.16 ms of bytes. F32
// storage must rank in full f32, so it stays on the CUDA cores
// (vst::F32Scan: a 4-row x 16-query register tile per thread, so that the
// FMA pipe and not shared memory limits the inner loop). F16 and BF16 rows
// take the tensor cores (vst::TensorScan: wgmma with f32 accumulation):
// 0.27 ms of operations at 989 TFLOP/s against 0.08 ms of bytes, so what
// is left to pay is the traffic from L2 into shared memory (the query
// slices are re-read for every 128 rows) and the fold. See hopper_scan.cuh.
//
// The grid puts the query tiles of one row block next to each other
// (blockIdx.x), so the blocks that read the same rows run together and
// the rows come from L2 after the first read: device memory sees the
// vectors about once. A block's shared memory is a constant: any dp fits.
#include "hopper_scan.cuh"

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(vst::TensorScan<T, T, N>::THREADS, 2)
    fused_scan_tensor(const __grid_constant__ typename vst::TensorScan<T, T, N>::Source src,
                      const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out_rank, int* __restrict__ out_row,
                      int nq, int block_rows, int dp, int out_cols) {
  using Core = vst::TensorScan<T, T, N>;
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int q0 = blockIdx.x * N, blk = blockIdx.y;
  const int64_t out0 = (int64_t)q0 * out_cols + blk * vst::LANES;
  Core::scan_group(ring, src, q0, min(N, nq - q0), a, b, (int64_t)blk * block_rows, block_rows, dp,
                   out_rank + out0, out_row + out0, out_cols);
}

template <int GROUPS>
__global__ void __launch_bounds__(vst::F32Scan<GROUPS>::THREADS, 1)
    fused_scan_f32(const __grid_constant__ typename vst::F32Scan<GROUPS>::Source src,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out_rank, int* __restrict__ out_row,
                   int nq, int block_rows, int dp, int out_cols) {
  using Core = vst::F32Scan<GROUPS>;
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int q0 = blockIdx.x * Core::NQ_TILE, blk = blockIdx.y;
  const int64_t out0 = (int64_t)q0 * out_cols + blk * vst::LANES;
  Core::scan_group(ring, src, q0, min(Core::NQ_TILE, nq - q0), a, b, (int64_t)blk * block_rows, block_rows,
                   dp, out_rank + out0, out_row + out0, out_cols);
}

template <typename T, int N>
int launch_tensor(const void* q, const void* v, const float* a, const float* b, float* rank, int* row,
                  int nq, int cap, int block_rows, int dp, cudaStream_t stream) {
  using Core = vst::TensorScan<T, T, N>;
  if (block_rows > Core::MAX_ROWS) return (int)cudaErrorInvalidValue;
  typename Core::Source src{};
  cudaError_t err = Core::make_source(&src, v, cap, q, nq, dp);
  if (err == cudaSuccess) err = vst::allow_smem(fused_scan_tensor<T, N>, Core::Ring::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cap / block_rows;
  fused_scan_tensor<T, N><<<dim3((nq + N - 1) / N, nblk), Core::THREADS, Core::Ring::SMEM_BYTES, stream>>>(
      src, a, b, rank, row, nq, block_rows, dp, nblk * vst::LANES);
  return (int)cudaGetLastError();
}

// the query tile a block takes: the smallest of 16, 32, 64 that holds nq
template <typename T>
int launch_tensor_n(const void* q, const void* v, const float* a, const float* b, float* rank, int* row,
                    int nq, int cap, int block_rows, int dp, cudaStream_t stream) {
  if (nq <= 16) return launch_tensor<T, 16>(q, v, a, b, rank, row, nq, cap, block_rows, dp, stream);
  if (nq <= 32) return launch_tensor<T, 32>(q, v, a, b, rank, row, nq, cap, block_rows, dp, stream);
  return launch_tensor<T, 64>(q, v, a, b, rank, row, nq, cap, block_rows, dp, stream);
}

template <int GROUPS>
int launch_f32(const void* q, const void* v, const float* a, const float* b, float* rank, int* row,
               int nq, int cap, int block_rows, int dp, cudaStream_t stream) {
  using Core = vst::F32Scan<GROUPS>;
  typename Core::Source src{};
  cudaError_t err = Core::make_source(&src, v, cap, q, nq, dp);
  if (err == cudaSuccess) err = vst::allow_smem(fused_scan_f32<GROUPS>, Core::Ring::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cap / block_rows;
  fused_scan_f32<GROUPS><<<dim3((nq + Core::NQ_TILE - 1) / Core::NQ_TILE, nblk), Core::THREADS, Core::Ring::SMEM_BYTES, stream>>>(
      src, a, b, rank, row, nq, block_rows, dp, nblk * vst::LANES);
  return (int)cudaGetLastError();
}

// 16 queries a thread group of 128: one group for nq <= 16, else two (three
// or four groups leave a thread too few registers for its 4 x 16 tile)
int launch_f32_n(const void* q, const void* v, const float* a, const float* b, float* rank, int* row,
                 int nq, int cap, int block_rows, int dp, cudaStream_t stream) {
  if (nq <= 16) return launch_f32<1>(q, v, a, b, rank, row, nq, cap, block_rows, dp, stream);
  return launch_f32<2>(q, v, a, b, rank, row, nq, cap, block_rows, dp, stream);
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
      return launch_f32_n(queries, vectors, a, b, rank, row, nq, cap, block_rows, dp, s);
    case vst::F16:
      return launch_tensor_n<__half>(queries, vectors, a, b, rank, row, nq, cap, block_rows, dp, s);
    case vst::BF16:
      return launch_tensor_n<__nv_bfloat16>(queries, vectors, a, b, rank, row, nq, cap, block_rows, dp, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
