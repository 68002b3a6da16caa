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
// the other, each exactly as a block of its own would: the output does not
// depend on g. On the TPU a grid step had a fixed cost that g amortised;
// here blocks run in parallel and g only trades the block count against
// the work of each block (measured on the H100: PERF.md, and
// ops/ivf.py::choose_g).
//
// Storage types: F32/F16/BF16 rows with queries of the same type, or int8
// rows (the I8 index, v = round(127 v')) scanned by true-scale bf16
// queries with the 127x scale folded into (a, b) by the engine; an int8 x
// bf16 product is exact in f32, as the TPU kernel's cast to bf16 was.
//
// What bounds it on the H100: the bytes of the rows. A row meets only the
// s queries of its cluster (s = 32 for a 1024-query batch at nprobe 32):
// 2*s/4 = 16 operations per byte of an F32 row, below the CUDA cores'
// ridge of 20, and s (BF16) or 2*s (I8) per byte on the tensor cores,
// below their ridge of 295. The F32 instantiation keeps full f32 on the
// CUDA cores with a register tile large enough that the FMAs keep up with
// the bytes (vst::F32Scan); F16/BF16/I8 rows take the tensor cores
// (vst::TensorScan: wgmma, f32 accumulation, int8 converted to bf16 in
// registers), so that at Dp 1536 the product no longer outweighs the 2 GB
// of codes. Rows and queries stream through a ring of K-slices filled by
// TMA, so the copies overlap the arithmetic, cost the threads no address
// arithmetic, and a block's shared memory does not depend on Dp
// (hopper_scan.cuh). The s/N query tiles of a
// cluster are neighbouring blocks (blockIdx.x), so the second tile finds
// the rows in L2.
#include "hopper_scan.cuh"

namespace {

template <typename TQ, typename TV, int N>
__global__ void __launch_bounds__(vst::TensorScan<TQ, TV, N>::THREADS, 2)
    grouped_scan_tensor(const __grid_constant__ typename vst::TensorScan<TQ, TV, N>::Source src,
                        const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out_rank, int* __restrict__ out_row,
                        int s, int cmax, int dp, int g) {
  using Core = vst::TensorScan<TQ, TV, N>;
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int t0 = blockIdx.x * N;  // first slot of this tile
  for (int gi = 0; gi < g; ++gi) {
    const int c = blockIdx.y * g + gi;
    const int64_t q0 = (int64_t)c * s + t0;
    Core::scan_group(ring, src, q0, min(N, s - t0), a, b, (int64_t)c * cmax, cmax, dp,
                     out_rank + q0 * vst::LANES, out_row + q0 * vst::LANES, vst::LANES);
  }
}

template <int GROUPS>
__global__ void __launch_bounds__(vst::F32Scan<GROUPS>::THREADS, 1)
    grouped_scan_f32(const __grid_constant__ typename vst::F32Scan<GROUPS>::Source src,
                     const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out_rank, int* __restrict__ out_row,
                     int s, int cmax, int dp, int g) {
  using Core = vst::F32Scan<GROUPS>;
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int t0 = blockIdx.x * Core::NQ_TILE;  // first slot of this tile
  for (int gi = 0; gi < g; ++gi) {
    const int c = blockIdx.y * g + gi;
    const int64_t q0 = (int64_t)c * s + t0;
    Core::scan_group(ring, src, q0, min(Core::NQ_TILE, s - t0), a, b, (int64_t)c * cmax, cmax, dp,
                     out_rank + q0 * vst::LANES, out_row + q0 * vst::LANES, vst::LANES);
  }
}

template <typename TQ, typename TV, int N>
int launch_tensor(const void* qg, const void* v, const float* a, const float* b, float* rank, int* row,
                  int nlist, int s, int cmax, int dp, int g, cudaStream_t stream) {
  using Core = vst::TensorScan<TQ, TV, N>;
  if (cmax > Core::MAX_ROWS) return (int)cudaErrorInvalidValue;
  typename Core::Source src{};
  cudaError_t err = Core::make_source(&src, v, (uint64_t)nlist * cmax, qg, (uint64_t)nlist * s, dp);
  if (err == cudaSuccess) err = vst::allow_smem(grouped_scan_tensor<TQ, TV, N>, Core::Ring::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  grouped_scan_tensor<TQ, TV, N><<<dim3((s + N - 1) / N, nlist / g), Core::THREADS, Core::Ring::SMEM_BYTES, stream>>>(
      src, a, b, rank, row, s, cmax, dp, g);
  return (int)cudaGetLastError();
}

// the query tile a block takes: the smallest of 16, 32, 64 that holds s
template <typename TQ, typename TV>
int launch_tensor_n(const void* qg, const void* v, const float* a, const float* b, float* rank, int* row,
                    int nlist, int s, int cmax, int dp, int g, cudaStream_t stream) {
  if (s <= 16) return launch_tensor<TQ, TV, 16>(qg, v, a, b, rank, row, nlist, s, cmax, dp, g, stream);
  if (s <= 32) return launch_tensor<TQ, TV, 32>(qg, v, a, b, rank, row, nlist, s, cmax, dp, g, stream);
  return launch_tensor<TQ, TV, 64>(qg, v, a, b, rank, row, nlist, s, cmax, dp, g, stream);
}

template <int GROUPS>
int launch_f32(const void* qg, const void* v, const float* a, const float* b, float* rank, int* row,
               int nlist, int s, int cmax, int dp, int g, cudaStream_t stream) {
  using Core = vst::F32Scan<GROUPS>;
  typename Core::Source src{};
  cudaError_t err = Core::make_source(&src, v, (uint64_t)nlist * cmax, qg, (uint64_t)nlist * s, dp);
  if (err == cudaSuccess) err = vst::allow_smem(grouped_scan_f32<GROUPS>, Core::Ring::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  grouped_scan_f32<GROUPS><<<dim3((s + Core::NQ_TILE - 1) / Core::NQ_TILE, nlist / g), Core::THREADS, Core::Ring::SMEM_BYTES, stream>>>(
      src, a, b, rank, row, s, cmax, dp, g);
  return (int)cudaGetLastError();
}

// 16 slots a thread group of 128: one group for s <= 16, else two (three or
// four groups leave a thread too few registers for its 4 x 16 tile)
int launch_f32_n(const void* qg, const void* v, const float* a, const float* b, float* rank, int* row,
                 int nlist, int s, int cmax, int dp, int g, cudaStream_t stream) {
  if (s <= 16) return launch_f32<1>(qg, v, a, b, rank, row, nlist, s, cmax, dp, g, stream);
  return launch_f32<2>(qg, v, a, b, rank, row, nlist, s, cmax, dp, g, stream);
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
  if (g < 1 || nlist % g) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch_f32_n(queries_grouped, vectors, a, b, rank, row, nlist, s, cmax, dp, g, st);
    case vst::F16:
      return launch_tensor_n<__half, __half>(queries_grouped, vectors, a, b, rank, row, nlist, s, cmax,
                                             dp, g, st);
    case vst::BF16:
      return launch_tensor_n<__nv_bfloat16, __nv_bfloat16>(queries_grouped, vectors, a, b, rank, row,
                                                           nlist, s, cmax, dp, g, st);
    case vst::I8:
      return launch_tensor_n<__nv_bfloat16, int8_t>(queries_grouped, vectors, a, b, rank, row, nlist, s,
                                                    cmax, dp, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
