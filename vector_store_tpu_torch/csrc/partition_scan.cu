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
// What bounds it on the H100: the bytes of the buckets the batch reads. A
// row meets only the queries of its bucket (about 2 at B 2048 over 1025
// partitions): a few operations per byte, far below every ridge. At the
// local-index shape (B 2048 drawn uniformly over 1025 buckets of pmax 1024,
// dp 128) the batch names ~886 distinct buckets: 0.47 GB of F32 rows (0.14
// ms at 3.35 TB/s), 0.24 GB of BF16; read once for every query naming it,
// they would be 1.09 GB. So the queries of a bucket share its rows.
//
// Design, three kernels on the caller's stream (no host synchronisation):
// - order_queries sorts the batch by bucket, stably: each query counts the
//   queries with a smaller bucket id and those before it with the same id,
//   which gives its sorted position (perm) and the first sorted position of
//   its bucket (run_start), and copies its row to the sorted position. A
//   tile of up to TILE queries of one bucket is then a contiguous row range
//   of the sorted queries: the box the TMA unit copies. (The sort costs
//   B * B comparisons, 4M at B 2048, spread over B / 4 warps; the same
//   steps as torch.sort, searchsorted and index_select from Python took
//   more host time than the scan of a whole B 64 batch.)
// - block (i, c) serves sorted position i. It works only where a tile of
//   its bucket starts (every TILE-th query of the bucket) and otherwise
//   exits at once, so the grid follows from B alone;
// - the tile's rows are scanned by the cores of hopper_scan.cuh: TensorScan
//   (wgmma, f32 accumulation) for F16/BF16 rows, F32Scan (f32 FMAs) for F32
//   rows, both fed by TMA through a ring of K-slices whose size does not
//   depend on dp. Rows past a short tile's queries are other buckets' (or
//   TMA's zeros) and are never written back. The F32 core keeps 2 rows of
//   its lane a thread (256-row passes, not the 4 and 512 of the fused and
//   grouped scans): a tile holds about 2 queries, so its FMAs cost little,
//   and the ring's 105 KB let two blocks share an SM, one streaming while
//   the other starts or ends a tile (the 4-row core's 203 KB kept one);
// - the wrapper splits each bucket's pmax rows into `splits` chunks of
//   chunk_rows (a multiple of 128) when the batch is too small to fill the
//   card; chunk c is block column c (blockIdx.y). Every chunk writes its
//   per-(query, lane) candidates in sorted order, and a second, small kernel
//   merges the chunks in row order with a strict < (the unsplit fold's
//   result: ties go to the smaller position) and writes each query's row
//   through the sort's permutation.
#include "hopper_scan.cuh"

namespace {

constexpr int TILE = 16;  // queries a block: TensorScan<T, T, 16> and F32Scan<1, 2>
constexpr int ORDER_QUERIES = 32, ORDER_WARPS = 8;  // order_queries: queries, warps a block

// Block x orders queries [32 x, 32 x + 32), lane n its query n. Warp w
// counts over its eighth of the batch; one 16-byte vector a lane copies
// the rows (dp * sizeof(T) is a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(ORDER_QUERIES * ORDER_WARPS)
    order_queries(const int* __restrict__ bsel, const T* __restrict__ queries, int nq, int dp,
                  int* __restrict__ perm, int* __restrict__ sorted_bsel, int* __restrict__ run_start,
                  T* __restrict__ queries_sorted) {
  __shared__ int less_part[ORDER_WARPS][ORDER_QUERIES], same_part[ORDER_WARPS][ORDER_QUERIES];
  __shared__ int sorted_at[ORDER_QUERIES];
  const int lane = threadIdx.x % ORDER_QUERIES, w = threadIdx.x / ORDER_QUERIES;
  const int i = blockIdx.x * ORDER_QUERIES + lane;
  const int id = i < nq ? bsel[i] : 0;
  const int share = (nq + ORDER_WARPS - 1) / ORDER_WARPS;
  int less = 0, same = 0;
#pragma unroll 8
  for (int j = w * share; j < min(nq, (w + 1) * share); ++j) {
    const int other = bsel[j];  // one address across the warp: a broadcast
    less += other < id;
    same += other == id && j < i;
  }
  less_part[w][lane] = less;
  same_part[w][lane] = same;
  __syncthreads();
  if (w == 0 && i < nq) {
    for (int u = 1; u < ORDER_WARPS; ++u) {
      less += less_part[u][lane];
      same += same_part[u][lane];
    }
    perm[less + same] = i;
    sorted_bsel[less + same] = id;
    run_start[less + same] = less;
    sorted_at[lane] = less + same;
  }
  __syncthreads();
  const int vecs = dp * (int)sizeof(T) / 16;
  for (int n = w; n < ORDER_QUERIES && blockIdx.x * ORDER_QUERIES + n < nq; n += ORDER_WARPS) {
    const uint4* from = reinterpret_cast<const uint4*>(queries + (int64_t)(blockIdx.x * ORDER_QUERIES + n) * dp);
    uint4* to = reinterpret_cast<uint4*>(queries_sorted + (int64_t)sorted_at[n] * dp);
    for (int c = lane; c < vecs; c += ORDER_QUERIES) to[c] = from[c];
  }
}

template <typename Core, int MIN_BLOCKS>
__global__ void __launch_bounds__(Core::THREADS, MIN_BLOCKS)
    partition_scan_kernel(const __grid_constant__ typename Core::Source src, const float* __restrict__ a,
                          const float* __restrict__ b, const int* __restrict__ sorted_bsel,
                          const int* __restrict__ run_start, float* __restrict__ chunk_rank,
                          int* __restrict__ chunk_pos, int nq, int nparts, int pmax, int chunk_rows, int dp) {
  static_assert(Core::THREADS >= vst::LANES, "a thread for every lane");
  const int i = blockIdx.x, c = blockIdx.y;
  if ((i - run_start[i]) % TILE) return;  // not the first query of a tile
  const int id = sorted_bsel[i];
  int nqt = 1;
  while (nqt < TILE && i + nqt < nq && sorted_bsel[i + nqt] == id) ++nqt;
  // the wrapper's contract is 0 <= bsel < nparts; clamp so that a bad id
  // can never read outside the mirror
  const int p = min(max(id, 0), nparts - 1);
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int64_t out0 = ((int64_t)c * nq + i) * vst::LANES;
  Core::scan_group(ring, src, i, nqt, a, b, (int64_t)p * pmax + (int64_t)c * chunk_rows,
                   min(chunk_rows, pmax - c * chunk_rows), dp, chunk_rank + out0, chunk_pos + out0, vst::LANES);
}

// One thread per (sorted query, lane): the first chunk's candidate, then
// each later chunk's where it ranks strictly lower; written to the query's
// own row.
__global__ void merge_chunks(const float* __restrict__ chunk_rank, const int* __restrict__ chunk_pos,
                             const int* __restrict__ perm, float* __restrict__ rank, int* __restrict__ pos,
                             int nq, int splits) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t cells = (int64_t)nq * vst::LANES;
  if (cell >= cells) return;
  float best = chunk_rank[cell];
  int at = chunk_pos[cell];
  for (int c = 1; c < splits; ++c) {
    const float r = chunk_rank[c * cells + cell];
    if (r < best) {
      best = r;
      at = chunk_pos[c * cells + cell];
    }
  }
  const int64_t out = (int64_t)perm[cell / vst::LANES] * vst::LANES + cell % vst::LANES;
  rank[out] = best;
  pos[out] = at;
}

template <typename T, typename Core, int MIN_BLOCKS>
int launch(const void* q, const void* v, const float* a, const float* b, const int* bsel, void* q_sorted,
           int* order, float* chunk_rank, int* chunk_pos, float* rank, int* pos, int nq, int nparts, int pmax,
           int dp, int chunk_rows, int device, cudaStream_t stream) {
  // raised once for each instantiation and device: the attribute call
  // costs host time that a small batch's launch cannot spare
  static bool smem_raised[64];
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const int splits = (pmax + chunk_rows - 1) / chunk_rows;
  int *perm = order, *sorted_bsel = order + nq, *run_start = order + 2 * nq;
  order_queries<T><<<(nq + ORDER_QUERIES - 1) / ORDER_QUERIES, ORDER_QUERIES * ORDER_WARPS, 0, stream>>>(
      bsel, static_cast<const T*>(q), nq, dp, perm, sorted_bsel, run_start, static_cast<T*>(q_sorted));
  cudaError_t err = cudaGetLastError();
  // the scan's set-up runs on the host while the card sorts
  typename Core::Source src{};
  if (err == cudaSuccess) err = Core::make_source(&src, v, (uint64_t)nparts * pmax, q_sorted, (uint64_t)nq, dp);
  if (err == cudaSuccess && !smem_raised[device]) {
    err = vst::allow_smem(partition_scan_kernel<Core, MIN_BLOCKS>, Core::Ring::SMEM_BYTES);
    smem_raised[device] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  partition_scan_kernel<Core, MIN_BLOCKS><<<dim3(nq, splits), Core::THREADS, Core::Ring::SMEM_BYTES, stream>>>(
      src, a, b, sorted_bsel, run_start, chunk_rank, chunk_pos, nq, nparts, pmax, chunk_rows, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = (int64_t)nq * vst::LANES;
  merge_chunks<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(chunk_rank, chunk_pos, perm, rank, pos, nq,
                                                                    splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch, written here: queries_sorted [nq, dp] (16-byte aligned, as
// `queries`); order [3, nq] i32: perm (a stable sort of bsel by bucket),
// sorted_bsel = bsel[perm] and run_start (the first sorted position of each
// sorted query's bucket); chunk_rank / chunk_pos: splits x nq x 128
// candidates in sorted order, splits = ceil(pmax / chunk_rows).
extern "C" int vst_partition_scan(const void* queries, const void* part_vecs, const float* a, const float* b,
                                  const int* bsel, void* queries_sorted, int* order, float* chunk_rank,
                                  int* chunk_pos, float* rank, int* pos, int nq, int nparts, int pmax, int dp,
                                  int dtype, int chunk_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // a chunk's passes count in 16 bits (TensorScan::MAX_ROWS); splits fit gridDim.y
  if (nq < 1 || nparts < 1 || pmax % vst::LANES || chunk_rows < vst::LANES || chunk_rows % vst::LANES ||
      chunk_rows > 65535 * vst::LANES || (pmax + chunk_rows - 1) / chunk_rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch<float, vst::F32Scan<1, 2>, 2>(queries, part_vecs, a, b, bsel, queries_sorted, order,
                                                  chunk_rank, chunk_pos, rank, pos, nq, nparts, pmax, dp,
                                                  chunk_rows, device, st);
    case vst::F16:
      return launch<__half, vst::TensorScan<__half, __half, TILE>, 2>(
          queries, part_vecs, a, b, bsel, queries_sorted, order, chunk_rank, chunk_pos, rank, pos, nq, nparts,
          pmax, dp, chunk_rows, device, st);
    case vst::BF16:
      return launch<__nv_bfloat16, vst::TensorScan<__nv_bfloat16, __nv_bfloat16, TILE>, 2>(
          queries, part_vecs, a, b, bsel, queries_sorted, order, chunk_rank, chunk_pos, rank, pos, nq, nparts,
          pmax, dp, chunk_rows, device, st);
  }
  return (int)cudaErrorInvalidValue;
}
