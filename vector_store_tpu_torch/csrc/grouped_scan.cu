// Kernel 2: grouped rank scan over the IVF engine's cluster-major region,
// over the dense slot plane with g clusters per block (kernel 4), or over
// a compact list of (query, cluster) pairs (the search path).
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
//
// Two work mappings of the same cores:
// - the dense slot plane (vst_grouped_scan), the TPU kernel's static
//   layout: grid ceil(s/N) x nlist/g, every slot scanned, filled or not.
//   After a skewed batch the engine raises s to 1024-2048 for good (the
//   JAX engine's rule), and at s 2048 over nlist 2048 the plane holds
//   4,194,304 slots, 1.6% of them filled for that batch: the kernel then
//   scanned and wrote ~100x the work it had.
// - the compact pair list (vst_grouped_scan_pairs): the B * nprobe pairs
//   sorted by cluster, cluster c's scanned pairs the rows [starts[c],
//   starts[c] + counts[c]) of the query array, and the outputs at the same
//   rows. The work is the scanned pairs, whatever s is: a small kernel
//   counts each cluster's query tiles, ceil(counts[c] / N), writes their
//   exclusive prefix and, for every tile, its cluster; the scan launches
//   ceil(P / N) + nlist blocks (a bound on the tiles known on the host,
//   so nothing waits for the device), and each block reads its cluster
//   from that map, exits past the last tile, and scans its tile with the
//   same core call as a dense block. A cluster's tiles are neighbouring
//   blocks, as in the plane. Rows of dropped pairs are neither scanned,
//   read nor written. N follows the mean pairs a cluster (2 P / nlist,
//   the slot budget a balanced batch gets), not s. The map costs a block
//   two dependent loads before its first copy; a binary search over the
//   prefix would cost ~log2(nlist), 11 at nlist 2048, all of them waited
//   for before the block's first copy is in flight.
#include "hopper_scan.cuh"

namespace {

// A block's dense tile: query tile blockIdx.x of clusters blockIdx.y * g ..
// + g - 1, one after the other, each exactly as a block of its own would.
template <typename Core, int QT, int MIN_BLOCKS>
__global__ void __launch_bounds__(Core::THREADS, MIN_BLOCKS)
    grouped_scan_dense(const __grid_constant__ typename Core::Source src, const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out_rank, int* __restrict__ out_row,
                       int s, int g, int cmax, int dp) {
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  const int t0 = blockIdx.x * QT;  // first slot of this tile
  for (int gi = 0; gi < g; ++gi) {
    const int c = blockIdx.y * g + gi;
    const int64_t q0 = (int64_t)c * s + t0;
    Core::scan_group(ring, src, q0, min(QT, s - t0), a, b, (int64_t)c * cmax, cmax, dp,
                     out_rank + q0 * vst::LANES, out_row + q0 * vst::LANES, vst::LANES);
  }
}

constexpr int PREFIX_THREADS = 1024;

// One block: tiles[c] = sum over c' < c of ceil(counts[c'] / qt),
// tiles[nlist] the total, and tile_cluster[t] the cluster of tile t < cap
// (the scan's blocks). Thread i sums a run of clusters; the runs' sums are
// scanned in shared memory.
__global__ void __launch_bounds__(PREFIX_THREADS)
    tile_prefix(const int* __restrict__ counts, int* __restrict__ tiles, int* __restrict__ tile_cluster, int nlist,
                int qt, int cap) {
  __shared__ int part[PREFIX_THREADS];
  const int per = (nlist + PREFIX_THREADS - 1) / PREFIX_THREADS;
  const int lo = min(nlist, (int)threadIdx.x * per), hi = min(nlist, lo + per);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += (max(counts[c], 0) + qt - 1) / qt;
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < PREFIX_THREADS; off <<= 1) {  // inclusive scan
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (int c = lo; c < hi; ++c) {
    const int n = (max(counts[c], 0) + qt - 1) / qt;
    tiles[c] = run;
    for (int t = run; t < min(cap, run + n); ++t) tile_cluster[t] = c;
    run += n;
  }
  if (threadIdx.x == PREFIX_THREADS - 1) tiles[nlist] = part[PREFIX_THREADS - 1];
}

// A block's compact tile: tile blockIdx.x of the list, in cluster c =
// tile_cluster[blockIdx.x], pairs [starts[c] + t0, + nqt) of the query
// array. Blocks past the last tile exit at once, before they touch shared
// memory. Pairs outside [0, n_pairs) are never scanned, whatever starts
// and counts say.
template <typename Core, int QT, int MIN_BLOCKS>
__global__ void __launch_bounds__(Core::THREADS, MIN_BLOCKS)
    grouped_scan_pairs(const __grid_constant__ typename Core::Source src, const float* __restrict__ a,
                       const float* __restrict__ b, const int* __restrict__ starts, const int* __restrict__ counts,
                       const int* __restrict__ tiles, const int* __restrict__ tile_cluster,
                       float* __restrict__ out_rank, int* __restrict__ out_row, int nlist, int n_pairs, int cmax,
                       int dp) {
  const int tile = blockIdx.x;
  if (tile >= tiles[nlist]) return;
  const int c = tile_cluster[tile], t0 = (tile - tiles[c]) * QT;
  const int64_t q0 = (int64_t)starts[c] + t0;
  if (q0 < 0 || q0 >= n_pairs) return;
  const int nqt = min(min(QT, counts[c] - t0), (int)(n_pairs - q0));
  if (nqt <= 0) return;
  extern __shared__ uint8_t smem[];
  typename Core::Ring ring = Core::Ring::make(smem);
  Core::scan_group(ring, src, q0, nqt, a, b, (int64_t)c * cmax, cmax, dp, out_rank + q0 * vst::LANES,
                   out_row + q0 * vst::LANES, vst::LANES);
}

// One scan: queries [n_queries, dp] (the slot plane, or the pairs) over the
// rows of nlist clusters of cmax; starts == nullptr for the dense plane.
struct Job {
  const void* queries;
  uint64_t n_queries;
  const void* vectors;
  const float* a;
  const float* b;
  float* rank;
  int* row;
  int nlist, cmax, dp, device;
  int s, g;                            // the dense plane
  const int* starts;                   // the pair list
  const int* counts;
  int* tiles;                          // scratch: [nlist + 1] prefix, then the tile -> cluster map
};

// Raise `kernel`'s shared-memory limit once a device (`raised` is the
// kernel's own flags): the attribute call costs host time that a small
// batch's launch cannot spare.
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t smem, int device, bool (&raised)[64]) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (raised[device]) return cudaSuccess;
  const cudaError_t err = vst::allow_smem(kernel, smem);
  raised[device] = err == cudaSuccess;
  return err;
}

template <typename Core, int QT, int MIN_BLOCKS>
int launch(const Job& j, cudaStream_t stream) {
  constexpr size_t SMEM = Core::Ring::SMEM_BYTES;
  static bool dense_raised[64], pairs_raised[64];
  cudaError_t err = cudaSuccess;
  // sum of ceil(counts[c] / QT) <= ceil(sum of counts / QT) + nlist
  const uint64_t blocks = (j.n_queries + QT - 1) / QT + (uint64_t)j.nlist;
  if (j.starts != nullptr) {  // the tile map first: the scan's set-up runs on the host while the card counts
    tile_prefix<<<1, PREFIX_THREADS, 0, stream>>>(j.counts, j.tiles, j.tiles + j.nlist + 1, j.nlist, QT, (int)blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  typename Core::Source src{};
  err = Core::make_source(&src, j.vectors, (uint64_t)j.nlist * j.cmax, j.queries, j.n_queries, j.dp);
  if (err != cudaSuccess) return (int)err;
  if (j.starts == nullptr) {
    err = allow_smem_once(grouped_scan_dense<Core, QT, MIN_BLOCKS>, SMEM, j.device, dense_raised);
    if (err != cudaSuccess) return (int)err;
    grouped_scan_dense<Core, QT, MIN_BLOCKS><<<dim3((j.s + QT - 1) / QT, j.nlist / j.g), Core::THREADS, SMEM, stream>>>(
        src, j.a, j.b, j.rank, j.row, j.s, j.g, j.cmax, j.dp);
    return (int)cudaGetLastError();
  }
  err = allow_smem_once(grouped_scan_pairs<Core, QT, MIN_BLOCKS>, SMEM, j.device, pairs_raised);
  if (err != cudaSuccess) return (int)err;
  grouped_scan_pairs<Core, QT, MIN_BLOCKS><<<(unsigned)blocks, Core::THREADS, SMEM, stream>>>(
      src, j.a, j.b, j.starts, j.counts, j.tiles, j.tiles + j.nlist + 1, j.rank, j.row, j.nlist, (int)j.n_queries,
      j.cmax, j.dp);
  return (int)cudaGetLastError();
}

// the query tile a block takes: the smallest of 16, 32, 64 that holds
// `want` queries
template <typename TQ, typename TV>
int launch_tensor(const Job& j, int want, cudaStream_t stream) {
  if (j.cmax > vst::TensorScan<TQ, TV, 16>::MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (want <= 16) return launch<vst::TensorScan<TQ, TV, 16>, 16, 2>(j, stream);
  if (want <= 32) return launch<vst::TensorScan<TQ, TV, 32>, 32, 2>(j, stream);
  return launch<vst::TensorScan<TQ, TV, 64>, 64, 2>(j, stream);
}

// 16 queries a thread group of 128: one group for want <= 16, else two
// (three or four groups leave a thread too few registers for its 4 x 16
// tile)
int launch_f32(const Job& j, int want, cudaStream_t stream) {
  if (want <= 16) return launch<vst::F32Scan<1>, vst::F32Scan<1>::NQ_TILE, 1>(j, stream);
  return launch<vst::F32Scan<2>, vst::F32Scan<2>::NQ_TILE, 1>(j, stream);
}

// dtype: the storage type (vst::DType); queries share it, except for I8
// storage, whose queries are bf16.
int dispatch(const Job& j, int dtype, int want, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vst::F32:
      return launch_f32(j, want, st);
    case vst::F16:
      return launch_tensor<__half, __half>(j, want, st);
    case vst::BF16:
      return launch_tensor<__nv_bfloat16, __nv_bfloat16>(j, want, st);
    case vst::I8:
      return launch_tensor<__nv_bfloat16, int8_t>(j, want, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The dense slot plane: queries_grouped [nlist * s, dp], outputs
// [nlist * s, 128]; g clusters a block.
extern "C" int vst_grouped_scan(const void* queries_grouped,
                                const void* vectors, const float* a,
                                const float* b, float* rank, int* row,
                                int nlist, int s, int cmax, int dp, int dtype,
                                int g, int device, void* stream) {
  if (g < 1 || nlist % g) return (int)cudaErrorInvalidValue;
  const Job j{queries_grouped, (uint64_t)nlist * s, vectors, a, b, rank, row, nlist, cmax, dp, device, s, g,
              nullptr, nullptr, nullptr};
  return dispatch(j, dtype, s, device, stream);
}

// The compact pair list: queries [n_pairs, dp], cluster c's scanned pairs
// the rows [starts[c], starts[c] + counts[c]); outputs [n_pairs, 128] at
// the same rows, other rows unwritten; tiles: int32 scratch of
// nlist + 1 + ceil(n_pairs / 16) + nlist.
extern "C" int vst_grouped_scan_pairs(const void* queries, const void* vectors, const float* a,
                                      const float* b, const int* starts, const int* counts, int* tiles,
                                      float* rank, int* row, int nlist, int cmax, int dp, int dtype,
                                      int n_pairs, int device, void* stream) {
  if (nlist < 1 || n_pairs < 1) return (int)cudaErrorInvalidValue;
  const Job j{queries, (uint64_t)n_pairs, vectors, a, b, rank, row, nlist, cmax, dp, device, 0, 1, starts, counts,
              tiles};
  const int want = (int)((2 * (int64_t)n_pairs + nlist - 1) / nlist);
  return dispatch(j, dtype, want, device, stream);
}
