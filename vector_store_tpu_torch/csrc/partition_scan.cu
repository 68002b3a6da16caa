// Kernel 3: partition rank scan over the partition-major mirror of a local
// (per-partition) index.
//
// Replaces vector_store_tpu/ops/partition_scan.py::partition_rank_scan
// (the scalar-prefetch Pallas kernel). Partition bucket p owns positions
// [p*pmax, (p+1)*pmax) of part_vecs; query i scans only the bucket
// bsel[i]. For each query, candidate `lane` is the position with the
// smallest rank a*(q.v)+b among the bucket's positions p*pmax + lane +
// 128*j, ties going to the smaller position. Outputs, row-major [nq, 128]:
// the rank (f32) and the absolute position (i32, p*pmax + offset).
//
// What bounds it on the H100: every query reads its own pmax rows, so the
// scan does 2 FLOP per element it reads (0.5 op/byte in F32): far below
// every ridge, bound by device memory. At the local-index shape (B 2048,
// pmax 1024, dp 128) it reads 1.07 GB in F32 (0.32 ms at 3.35 TB/s) or
// 0.54 GB in BF16, whatever the table's total row count. The design is the
// simplest that streams each block once: one block per query with a
// one-query tile (a 16-query tile would waste 15/16 of its FMAs, since
// queries of one batch rarely share a bucket), the bucket's rows staged
// through shared memory with coalesced 16-byte loads (rank_scan.cuh).
#include "rank_scan.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(vst::LANES)
    partition_scan_kernel(const T* __restrict__ queries,
                          const T* __restrict__ part_vecs,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const int* __restrict__ bsel,
                          float* __restrict__ out_rank, int* __restrict__ out_pos,
                          int nparts, int pmax, int dp) {
  extern __shared__ float qs[];  // [1][dp], then the row tile
  const int64_t i = blockIdx.x;
  // the wrapper's contract is 0 <= bsel < nparts; clamp so that a bad id
  // can never read outside the mirror
  const int p = min(max(bsel[i], 0), nparts - 1);
  vst::stage_queries<1>(queries + i * dp, 1, dp, qs);
  __syncthreads();
  float best[1];
  int best_pos[1];
  vst::scan_rows(qs, qs + dp, part_vecs, a, b, (int64_t)p * pmax, pmax, dp,
                 best, best_pos);
  out_rank[i * vst::LANES + threadIdx.x] = best[0];
  out_pos[i * vst::LANES + threadIdx.x] = best_pos[0];
}

template <typename T>
int launch(const void* q, const void* v, const float* a, const float* b,
           const int* bsel, float* rank, int* pos, int nq, int nparts,
           int pmax, int dp, cudaStream_t stream) {
  const size_t smem = vst::smem_bytes(dp, 1);
  cudaError_t err = vst::allow_smem(partition_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  partition_scan_kernel<T><<<nq, vst::LANES, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), a, b, bsel, rank,
      pos, nparts, pmax, dp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vst_partition_scan(const void* queries, const void* part_vecs,
                                  const float* a, const float* b,
                                  const int* bsel, float* rank, int* pos,
                                  int nq, int nparts, int pmax, int dp,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch<float>(queries, part_vecs, a, b, bsel, rank, pos, nq,
                           nparts, pmax, dp, st);
    case vst::F16:
      return launch<__half>(queries, part_vecs, a, b, bsel, rank, pos, nq,
                            nparts, pmax, dp, st);
    case vst::BF16:
      return launch<__nv_bfloat16>(queries, part_vecs, a, b, bsel, rank, pos,
                                   nq, nparts, pmax, dp, st);
  }
  return (int)cudaErrorInvalidValue;
}
