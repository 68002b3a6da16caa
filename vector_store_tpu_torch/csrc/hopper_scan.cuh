// The two scan cores of every rank-scan kernel of the port, designed for
// Hopper (sm_90a): the fused scan (fused_scan.cu), the grouped scan
// (grouped_scan.cu) and the partition scan (partition_scan.cu). They replace
// the bodies of the Pallas kernels vector_store_tpu/ops/pallas_scan.py::
// _fused_scan, vector_store_tpu/ops/ivf.py::_grouped_scan (and, through the
// grouped scan's g argument, scripts/ivf_stage_opt2.py::_grouped_scan_g)
// and vector_store_tpu/ops/partition_scan.py::partition_rank_scan.
//
// Both cores compute, for one group of stored rows (a block_rows block, a
// cluster, a partition's bucket or a chunk of one; a multiple of 128 rows)
// and a tile of query rows, the affine
// rank r = a[row] * (q . v[row]) + b[row] of every (query, row) pair,
// folded to 128 candidates per query: candidate `lane` is the row with the
// smallest rank among the group's rows at offset == lane (mod 128), equal
// ranks going to the smaller row. Dead rows carry b = 1e30; a lane whose
// rows are all dead returns its first row at 1e30.
//
// What bounds the scans on the H100 (3.35 TB/s, 67 TFLOP/s f32 on the CUDA
// cores, 989 TFLOP/s bf16/f16 on the tensor cores):
// - F32 rows must rank in full f32 (no TF32, no bf16 split), so their
//   product stays on the CUDA cores: the fused scan (hundreds of queries a
//   row) is bound by f32 operations, the grouped scan (tens of queries a
//   row) by the bytes of the rows as long as the FMA loop keeps up;
// - F16/BF16/I8 rows go to the tensor cores, where the product costs almost
//   nothing: the grouped scan is bound by the bytes of the rows, the fused
//   scan by its operations only at a thousand queries a row.
//
// Core A, TensorScan (F16, BF16, and I8 rows under bf16 queries): a block
// is two warpgroups. Warpgroup h multiplies the 64 rows
// [base + 128 j + 64 h, + 64) of pass j by the block's N queries with
// wgmma.mma_async (m64nNk16, f32 accumulation; the products are exact in
// f32). The accumulator element a thread holds at (row i, query n) belongs
// to lane 64 h + i in every pass, so the running (min rank, winning j)
// lives in a fragment of the accumulator's layout and is compared element
// by element after each pass, passes in increasing j with a strict <: no
// shuffle, the first row keeps ties. The row index is rebuilt from j at
// the end. I8 rows are copied to shared memory as bytes, read into
// registers (each thread picks the two code pairs of its accumulator rows
// out of every 16 codes), converted exactly to bf16 there and given to
// wgmma as its register operand, the bf16 queries staying in shared
// memory: no scale argument, the 127x scale is folded into (a, b).
//
// Core B, F32Scan: f32 FMAs on the CUDA cores. A thread owns one lane and
// keeps RJ = 4 rows of it (lane + 128 jj) x 16 queries in registers: per 4
// dimensions it makes 4 row reads and 16 query broadcasts (16-byte shared
// loads) for 256 FMAs, so the FMA pipe and not shared memory is the limit.
// A block of 256 threads is two such halves over the same 512 rows and 32
// queries (a block of 128 threads serves tiles of at most 16 queries). The
// partition scan, whose tiles hold a few queries, takes RJ = 2: half the
// FMAs a row read, half the ring.
//
// Staging, both cores: rows AND queries stream through a ring of K-slices
// (128 bytes of every row a slice; 4 stages in core A, 3 in core B), so a
// block's shared memory does not depend on Dp, and copying slice i + 2
// overlaps the arithmetic of slice i. The slices arrive by TMA: one thread
// asks for a box of rows and a box of queries out of tensor maps of the two
// arrays (built per launch by the C entry point), the unit writes them
// under the 128-byte swizzle that wgmma's descriptors (core A) and the
// conflict-free 16-byte reads (core B) expect, fills what lies past the
// last dimension and the last query with zeros, and reports the bytes to
// the stage's mbarrier, on which the block waits. The first version filled
// the ring with cp.async from all threads; the scans bound by bytes then
// stopped at about half the card's memory rate whatever the ring's depth,
// and the fused scan spent more instructions on addresses than on MMAs.
// A stage is reused after a block-wide barrier, not an "empty" mbarrier:
// every thread both multiplies and folds, so there is no producer warp to
// run ahead. The query slices are re-read from L2 for every pass.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

// Switches of bench/scan_ablation.py, which times the scans with one part
// of a core cut out (the results are then wrong by design). None is defined
// in the library's own build, where each macro is the constant `true` or the
// plain address. The cut-out work hides behind dp < 0, which never holds but
// which the compiler cannot know, so the code around it stays as it is.
#ifdef VST_ABLATE_PRODUCT  // copy and synchronise, but no FMA and no MMA
#define VST_PRODUCT(dp) ((dp) < 0)
#else
#define VST_PRODUCT(dp) true
#endif
#ifdef VST_ABLATE_FOLD  // fold the first pass of a group only
#define VST_FOLD(first_pass) (first_pass)
#else
#define VST_FOLD(first_pass) true
#endif
#ifdef VST_ABLATE_QUERY_READS  // core B: one query's values for all 16
#define VST_QUERY_AT(i, c) ((c) << 2)
#else
#define VST_QUERY_AT(i, c) ((i) * KS + (((c) ^ ((i) & 7)) << 2))
#endif

namespace vst {

constexpr int LANES = 128;  // candidates a group: one per row offset mod 128

// storage types; I8 rows are scanned by bf16 queries (grouped scan only)
enum DType : int { F32 = 0, F16 = 1, BF16 = 2, I8 = 3 };

// Raise the dynamic shared-memory limit of `kernel` when a block needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes (64 16-bit elements) under the 128-byte swizzle: groups of 8 rows
// are 1024 bytes apart; the tile starts on a 1024-byte boundary. A k16
// step inside the slice advances the start address by 32 bytes (+2 here).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// -- TMA and mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void mbarrier_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
// one arrival that also announces `bytes` of asynchronous copies to come
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete. A copy that never
// arrives traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(bar), "r"(parity)
                 : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}
// TMA: copy the box at (inner coordinate c0, row c1) of the tensor `map`
// describes to shared memory; the bytes count towards `bar`. Coordinates
// past the tensor's extent read zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}

// Host side: the tensor map of a row-major [rows, dp] array, cut into boxes
// of box_rows rows. For 2- and 4-byte elements a box row is 128 bytes under
// the 128-byte swizzle (chunk c of box row r lands at chunk c ^ (r & 7):
// what wgmma's descriptor and F32Scan's reads expect); for int8 it is 64
// bytes, unswizzled. The encoder lives in libcuda and is looked up through
// the runtime, so the kernels' library links only the runtime.
template <typename T>
inline cudaError_t tensor_map(CUtensorMap* map, const T* base, uint64_t rows, uint64_t dp, uint32_t box_rows) {
  constexpr bool BYTES = sizeof(T) == 1;
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const CUtensorMapDataType type = BYTES                              ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : std::is_same<T, float>::value  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {dp, rows}, strides[1] = {dp * sizeof(T)};
  const cuuint32_t box[2] = {BYTES ? 64u : (cuuint32_t)(128 / sizeof(T)), box_rows}, steps[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<T*>(base), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              BYTES ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A block's ring in dynamic shared memory: STAGES stages of STAGE_BYTES
// from a 1024-byte boundary on (the swizzle's period), one mbarrier a stage
// ("slice landed"), and the count of slices the block has consumed so far,
// which carries the stage and the barriers' phase from one group to the next.
template <int STAGES, int STAGE_BYTES>
struct Ring {
  static constexpr size_t SMEM_BYTES = (size_t)STAGES * (STAGE_BYTES + 8) + 1024;
  uint8_t* stages;
  uint32_t landed;
  uint32_t consumed;

  __device__ static Ring make(uint8_t* dynamic_smem) {
    const uint32_t s = smem_u32(dynamic_smem);
    Ring ring;
    ring.stages = dynamic_smem + (((s + 1023u) & ~1023u) - s);
    ring.landed = smem_u32(ring.stages + STAGES * STAGE_BYTES);
    ring.consumed = 0;
    if (threadIdx.x == 0) {
      for (int st = 0; st < STAGES; ++st) mbarrier_init(ring.landed + 8 * st, 1);
      mbarrier_init_fence();
    }
    __syncthreads();
    return ring;
  }
  __device__ uint8_t* stage(uint32_t slice) const { return stages + (slice % STAGES) * STAGE_BYTES; }
  __device__ uint32_t barrier(uint32_t slice) const { return landed + 8 * (slice % STAGES); }
  // block until `slice` has landed in its stage
  __device__ void wait(uint32_t slice) const { mbarrier_wait(barrier(slice), (slice / STAGES) & 1); }
};

#define VST_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define VST_R16 VST_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define VST_R32 \
  VST_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define VST_D8(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define VST_D16(d)                                                                           \
  VST_D8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define VST_D32(d)                                                                              \
  VST_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D (+)= A B^T, A [64, 16] and B [N, 16] both K-major in shared memory
#define VST_WGMMA_SS(N, TYPE, REGS, OUTS, A, B, S)                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TYPE "." TYPE " {" REGS \
               "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"                                   \
               : OUTS                                                                   \
               : "l"(da), "l"(db), "r"(accumulate))
// the same with A [64, 16] in registers (four 32-bit registers a thread)
#define VST_WGMMA_RS(N, REGS, OUTS, A0, A1, A2, A3, B, S)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                                    \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, {" A0 ", " \
               A1 ", " A2 ", " A3 "}, " B ", p, 1, 1, 0;\n}\n"                                   \
               : OUTS                                                                            \
               : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "l"(db), "r"(accumulate))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "query tile of 16, 32 or 64");
  if constexpr (sizeof(T) == 2 && N == 16) {
    if constexpr (std::is_same<T, __half>::value) VST_WGMMA_SS(16, "f16", VST_R8, VST_D8(d), "%8", "%9", "%10");
    else VST_WGMMA_SS(16, "bf16", VST_R8, VST_D8(d), "%8", "%9", "%10");
  } else if constexpr (N == 32) {
    if constexpr (std::is_same<T, __half>::value) VST_WGMMA_SS(32, "f16", VST_R16, VST_D16(d), "%16", "%17", "%18");
    else VST_WGMMA_SS(32, "bf16", VST_R16, VST_D16(d), "%16", "%17", "%18");
  } else {
    if constexpr (std::is_same<T, __half>::value) VST_WGMMA_SS(64, "f16", VST_R32, VST_D32(d), "%32", "%33", "%34");
    else VST_WGMMA_SS(64, "bf16", VST_R32, VST_D32(d), "%32", "%33", "%34");
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&ra)[4], uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "query tile of 16, 32 or 64");
  if constexpr (N == 16) {
    VST_WGMMA_RS(16, VST_R8, VST_D8(d), "%8", "%9", "%10", "%11", "%12", "%13");
  } else if constexpr (N == 32) {
    VST_WGMMA_RS(32, VST_R16, VST_D16(d), "%16", "%17", "%18", "%19", "%20", "%21");
  } else {
    VST_WGMMA_RS(64, VST_R32, VST_D32(d), "%32", "%33", "%34", "%35", "%36", "%37");
  }
}

// Two int8 values of `word` as a bf16 pair, exactly; `pick` is the byte
// selector that spreads them into two 16-bit fields (0x4140: bytes 0 and
// 1; 0x4342: bytes 2 and 3). x = (x & 127) - 128 * (its sign bit), and
// 0x4300 | m is the bf16 value 128 + m for m < 128, 0x4380 the value 256:
// (128 + (x & 127)) - (128 or 256) is x, an exact bf16 difference.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t word, uint32_t pick) {
  const uint32_t w = __byte_perm(word, 0u, pick);
  const uint32_t low7 = (w & 0x007F007Fu) | 0x43004300u, sign = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 x = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low7),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sign));
  return *reinterpret_cast<const uint32_t*>(&x);
}

// -- core A: tensor cores -----------------------------------------------------------

// TQ: the queries' type (__half or __nv_bfloat16); TV: the rows' (TQ, or
// int8_t under bf16 queries); N: queries a block (16, 32 or 64).
template <typename TQ, typename TV, int N>
struct TensorScan {
  static constexpr bool I8_ROWS = sizeof(TV) == 1;
  static constexpr int THREADS = 2 * LANES;  // two warpgroups, 64 lanes each
  // dimensions a slice: 128 bytes of a row, a whole line of device memory
  // (64 16-bit elements, or two 64-code halves of an int8 row; the queries
  // of int8 rows take two 64-element tiles a slice)
  static constexpr int HALVES = I8_ROWS ? 2 : 1;
  static constexpr int KS = 64 * HALVES;
  static constexpr int MAX_ROWS = 65535 * LANES;  // a group's passes count in 16 bits
  static constexpr int STAGES = 4;
  // slices in flight ahead of the one being multiplied; with A in shared
  // memory the wgmma of the slice before is still reading its stage
  static constexpr int AHEAD = I8_ROWS ? STAGES - 1 : STAGES - 2;
  static constexpr int ROW_BYTES = LANES * KS * (int)sizeof(TV);
  static constexpr int STAGE_BYTES = ROW_BYTES + N * KS * 2;
  using Ring = vst::Ring<STAGES, STAGE_BYTES>;

  // Tensor maps of the row array (boxes of 128 rows) and the query array
  // (boxes of N rows), a __grid_constant__ kernel parameter.
  struct Source {
    CUtensorMap rows_map;
    CUtensorMap queries_map;
  };

  // Host side: the source of a scan of `queries` [n_queries, dp] over
  // `vectors` [n_rows, dp].
  static cudaError_t make_source(Source* src, const void* vectors, uint64_t n_rows, const void* queries,
                                 uint64_t n_queries, int dp) {
    cudaError_t err = tensor_map(&src->rows_map, static_cast<const TV*>(vectors), n_rows, dp, LANES);
    if (err != cudaSuccess) return err;
    return tensor_map(&src->queries_map, static_cast<const TQ*>(queries), n_queries, dp, N);
  }

  // Start the copies of the group's slice `nxt` (slice kn of pass jn) into
  // its stage, if the group has that many, and step (jn, kn) to the slice
  // after it. One thread asks the TMA unit for the boxes: a 64-element tile
  // of rows and one of queries per half. Coordinates past dp or past the
  // last query read zeros (a query tile cut short inside the array reads
  // rows that are never written back).
  __device__ __forceinline__ static void prefetch(const Ring& ring, const Source& src, int64_t row0,
                                                  int64_t q_row0, int nxt, int total, int& jn, int& kn, int nk) {
    if (nxt < total && threadIdx.x == 0) {
      const uint32_t bar = ring.barrier(ring.consumed + nxt), dst = smem_u32(ring.stage(ring.consumed + nxt));
      const int row = (int)(row0 + (int64_t)jn * LANES);
      mbarrier_expect(bar, STAGE_BYTES);
#pragma unroll
      for (int u = 0; u < HALVES; ++u) {
        tma_load_2d(dst + u * (ROW_BYTES / HALVES), &src.rows_map, kn * KS + 64 * u, row, bar);
        tma_load_2d(dst + ROW_BYTES + u * (N * 128), &src.queries_map, kn * KS + 64 * u, (int)q_row0, bar);
      }
    }
    if (++kn == nk) {
      kn = 0;
      ++jn;
    }
  }

  // The register operand of k16 step m of one 64-code half for the
  // accumulator rows lane_lo and lane_hi: x[m] holds a row's 16 codes of the
  // step, the thread takes codes 2 t, 2 t + 1 (first pair of registers) and
  // 8 + 2 t, 9 + 2 t (second pair), the layout of wgmma's A fragment.
  __device__ __forceinline__ static void i8_fragment(const uint4& lo, const uint4& hi, int t, uint32_t (&ra)[4]) {
    const bool odd = (t & 2) != 0;  // the pair lies in the second word of its 8 codes
    const uint32_t pick = (t & 1) ? 0x4342u : 0x4140u;
    ra[0] = i8x2_to_bf16x2(odd ? lo.y : lo.x, pick);
    ra[1] = i8x2_to_bf16x2(odd ? hi.y : hi.x, pick);
    ra[2] = i8x2_to_bf16x2(odd ? lo.w : lo.z, pick);
    ra[3] = i8x2_to_bf16x2(odd ? hi.w : hi.z, pick);
  }

  // Scan rows [row0, row0 + nrows) against the nqt <= N queries from row
  // q_row0 of the query array; write candidate lane of query n to
  // out_*[n * out_pitch + lane].
  __device__ static void scan_group(Ring& ring, const Source& src, int64_t q_row0, int nqt,
                                    const float* __restrict__ a, const float* __restrict__ b,
                                    int64_t row0, int nrows, int dp, float* __restrict__ out_rank,
                                    int* __restrict__ out_row, int64_t out_pitch) {
    const int tid = threadIdx.x;
    const int h = tid >> 7;  // warpgroup: lanes [64 h, 64 h + 64)
    // accumulator rows of this thread in its warpgroup's 64-row tile
    const int lane_lo = 64 * h + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2), lane_hi = lane_lo + 8;
    const int t = tid & 3;
    const int nk = (dp + KS - 1) / KS, total = (nrows / LANES) * nk;

    __syncthreads();  // the ring is free (a block may scan several groups)
    int jn = 0, kn = 0;  // pass and slice of the next slice to prefetch
    for (int i = 0; i < AHEAD; ++i) prefetch(ring, src, row0, q_row0, i, total, jn, kn, nk);

    float acc[N / 2], best[N / 2];
    uint32_t best_j[N / 4];  // the winning pass, 16 bits each: elements x and x + N / 4
#pragma unroll
    for (int x = 0; x < N / 2; ++x) best[x] = CUDART_INF_F;
#pragma unroll
    for (int x = 0; x < N / 4; ++x) best_j[x] = 0;
    float a_lo = 0.f, b_lo = 0.f, a_hi = 0.f, b_hi = 0.f;
    int j = 0, k = 0;  // pass (128 rows) and slice of the pass
    for (int i = 0; i < total; ++i) {
      const uint32_t slice = ring.consumed + i;
      ring.wait(slice);
      __syncthreads();  // everyone saw it land, and slice i - 1 (I8: its wgmma too) is consumed
      if (k == 0) {  // the pass's coefficients, needed after its last slice
        const int64_t base = row0 + (int64_t)j * LANES;
        a_lo = a[base + lane_lo];
        b_lo = b[base + lane_lo];
        a_hi = a[base + lane_hi];
        b_hi = b[base + lane_hi];
      }
      uint8_t* stage = ring.stage(slice);
      const uint64_t db = wgmma_desc(smem_u32(stage + ROW_BYTES));
      if constexpr (!I8_ROWS) {
        const uint64_t da = wgmma_desc(smem_u32(stage + h * (64 * 128)));
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (VST_PRODUCT(dp)) wgmma_ss<TQ, N>(acc, da + 2 * s, db + 2 * s, (k | s) != 0);
        wgmma_commit();
        prefetch(ring, src, row0, q_row0, i + AHEAD, total, jn, kn, nk);  // while the tensor cores run
        if (k == nk - 1) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();  // slice i - 1 is consumed; slice i may still run
        }
      } else {
#pragma unroll
        for (int u = 0; u < HALVES; ++u) {
          if (u) wgmma_wait<0>();  // the half before is done with the register operand
          // the 64 codes of the half, rows lane_lo and lane_hi: 16 a k16 step
          const uint4* lo = reinterpret_cast<const uint4*>(stage + u * (LANES * 64) + lane_lo * 64);
          const uint4* hi = reinterpret_cast<const uint4*>(stage + u * (LANES * 64) + lane_hi * 64);
          uint32_t ra[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) i8_fragment(lo[s], hi[s], t, ra[s]);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (VST_PRODUCT(dp)) wgmma_rs<N>(acc, ra[s], db + u * (N * 128 / 16) + 2 * s, (k | u | s) != 0);
          wgmma_commit();
        }
        prefetch(ring, src, row0, q_row0, i + AHEAD, total, jn, kn, nk);  // while the tensor cores run
        wgmma_wait<0>();  // the register operand is free again
      }
      if (++k == nk) {  // fold pass j into the running minimum
        if (VST_FOLD(j == 0)) {
#pragma unroll
          for (int x = 0; x < N / 2; ++x) {
            const bool upper = (x & 2) != 0;  // accumulator rows lane_lo, lane_lo + 8
            const float rank = fmaf(upper ? a_hi : a_lo, acc[x], upper ? b_hi : b_lo);
            if (rank < best[x]) {  // strict: the first (smallest) row keeps ties
              best[x] = rank;
              best_j[x % (N / 4)] = x < N / 4 ? (best_j[x % (N / 4)] & 0xFFFF0000u) | (uint32_t)j
                                              : (best_j[x % (N / 4)] & 0x0000FFFFu) | ((uint32_t)j << 16);
            }
          }
        }
        k = 0;
        ++j;
      }
    }
    ring.consumed += total;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      const int n = 8 * (x >> 2) + 2 * t + (x & 1);  // the accumulator's column
      const int lane = (x & 2) ? lane_hi : lane_lo;
      if (n < nqt) {
        out_rank[n * out_pitch + lane] = best[x];
        const uint32_t pair = best_j[x % (N / 4)];
        const int64_t won = x < N / 4 ? pair & 0xFFFFu : pair >> 16;
        out_row[n * out_pitch + lane] = (int)(row0 + won * LANES + lane);
      }
    }
  }
};

// -- core B: f32 on the CUDA cores ---------------------------------------------------

// GROUPS: thread groups of 128 (one thread a lane) a block; each group
// takes 16 of the block's queries over the same rows. RJ_: rows of its lane
// a thread keeps (4 or 2), RJ_ x 128 the rows of a pass.
template <int GROUPS, int RJ_ = 4>
struct F32Scan {
  static constexpr int THREADS = GROUPS * LANES;
  static constexpr int NQ = 16;                // queries a thread
  static constexpr int NQ_TILE = GROUPS * NQ;  // queries a block
  static constexpr int RJ = RJ_;               // rows a thread: lane + 128 jj
  static constexpr int KS = 32;                // dimensions a slice: 128 bytes a row
  static constexpr int PASS_ROWS = RJ * LANES;
  static constexpr int BOX_ROWS = LANES;  // rows a TMA box: a lane group
  static constexpr int STAGES = 3, AHEAD = STAGES - 1;
  static constexpr int STAGE_BYTES = (PASS_ROWS + NQ_TILE) * KS * 4;
  using Ring = vst::Ring<STAGES, STAGE_BYTES>;

  // Tensor maps of the row array and the query array, a __grid_constant__
  // kernel parameter. A staged row is 8 chunks of 16 bytes, chunk c of row
  // r at position c ^ (r & 7) (the TMA unit's 128-byte swizzle): the 8
  // lanes of a quarter warp read 8 different positions, so 16-byte reads
  // of one chunk index across lanes are conflict-free without padding.
  struct Source {
    CUtensorMap rows_map;
    CUtensorMap queries_map;
  };

  static cudaError_t make_source(Source* src, const void* vectors, uint64_t n_rows, const void* queries,
                                 uint64_t n_queries, int dp) {
    cudaError_t err = tensor_map(&src->rows_map, static_cast<const float*>(vectors), n_rows, dp, BOX_ROWS);
    if (err != cudaSuccess) return err;
    return tensor_map(&src->queries_map, static_cast<const float*>(queries), n_queries, dp, NQ_TILE);
  }

  // Start the copies of the group's slice `nxt` (slice kn of pass pn) into
  // its stage, if the group has that many, and step (pn, kn) on. A pass
  // shorter than PASS_ROWS (the group's last) copies only its own lane
  // groups; coordinates past dp or past the last query read zeros.
  __device__ __forceinline__ static void prefetch(const Ring& ring, const Source& src, int64_t row0,
                                                  int nrows, int64_t q_row0, int nxt, int total, int& pn,
                                                  int& kn, int nk) {
    if (nxt < total && threadIdx.x == 0) {
      const uint32_t bar = ring.barrier(ring.consumed + nxt), dst = smem_u32(ring.stage(ring.consumed + nxt));
      const int row = (int)(row0 + (int64_t)pn * PASS_ROWS);
      const int boxes = min(PASS_ROWS, nrows - pn * PASS_ROWS) / BOX_ROWS;
      mbarrier_expect(bar, (boxes * BOX_ROWS + NQ_TILE) * KS * 4);
      for (int u = 0; u < boxes; ++u)
        tma_load_2d(dst + u * (BOX_ROWS * KS * 4), &src.rows_map, kn * KS, row + u * BOX_ROWS, bar);
      tma_load_2d(dst + PASS_ROWS * KS * 4, &src.queries_map, kn * KS, (int)q_row0, bar);
    }
    if (++kn == nk) {
      kn = 0;
      ++pn;
    }
  }

  // acc[jj][i] += row (lane + 128 jj) . query i over the staged slice, for
  // the first R of the thread's rows; vs: the thread's first row, qs: its
  // group's first query, sw: the thread's swizzle (lane & 7, the same for
  // all its rows; query i's is i & 7)
  template <int R>
  __device__ __forceinline__ static void dot_slice(const float* __restrict__ vs, const float* __restrict__ qs,
                                                   int sw, float (&acc)[RJ][NQ]) {
#pragma unroll
    for (int c = 0; c < KS / 4; ++c) {
      float4 v[R];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) v[jj] = *reinterpret_cast<const float4*>(vs + jj * LANES * KS + ((c ^ sw) << 2));
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + VST_QUERY_AT(i, c));
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
          acc[jj][i] = fmaf(qv.w, v[jj].w, fmaf(qv.z, v[jj].z, fmaf(qv.y, v[jj].y, fmaf(qv.x, v[jj].x, acc[jj][i]))));
      }
    }
  }

  // As TensorScan::scan_group, for nqt <= NQ_TILE queries.
  __device__ static void scan_group(Ring& ring, const Source& src, int64_t q_row0, int nqt,
                                    const float* __restrict__ a, const float* __restrict__ b,
                                    int64_t row0, int nrows, int dp, float* __restrict__ out_rank,
                                    int* __restrict__ out_row, int64_t out_pitch) {
    const int lane = threadIdx.x & (LANES - 1), group = threadIdx.x >> 7;
    const int nk = (dp + KS - 1) / KS, npass = (nrows + PASS_ROWS - 1) / PASS_ROWS, total = npass * nk;

    __syncthreads();  // the ring is free (a block may scan several groups)
    int pn = 0, kn = 0;  // pass and slice of the next slice to prefetch
    for (int i = 0; i < AHEAD; ++i) prefetch(ring, src, row0, nrows, q_row0, i, total, pn, kn, nk);

    float acc[RJ][NQ], best[NQ], ra[RJ], rb[RJ];
    int best_row[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      best[i] = CUDART_INF_F;
      best_row[i] = (int)(row0 + lane);
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) acc[jj][i] = 0.f;
    }
    int p = 0, k = 0;  // pass (512 rows) and slice of the pass
    for (int i = 0; i < total; ++i) {
      const uint32_t slice = ring.consumed + i;
      ring.wait(slice);
      __syncthreads();  // everyone saw it land, and slice i - 1 is consumed
      prefetch(ring, src, row0, nrows, q_row0, i + AHEAD, total, pn, kn, nk);
      const int nj = min(RJ, (nrows - p * PASS_ROWS) / LANES);  // lane groups of this pass
      if (k == nk - 1) {  // the pass's coefficients, on their way during its last slice
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          const int64_t row = row0 + (int64_t)p * PASS_ROWS + min(jj, nj - 1) * LANES + lane;
          ra[jj] = a[row];
          rb[jj] = b[row];
        }
      }
      const float* stage = reinterpret_cast<const float*>(ring.stage(slice));
      const float* vs = stage + lane * KS;
      const float* qs = stage + (PASS_ROWS + group * NQ) * KS;
      if (VST_PRODUCT(dp)) switch (nj) {
        case 4: if constexpr (RJ >= 4) dot_slice<4>(vs, qs, lane & 7, acc); break;
        case 3: if constexpr (RJ >= 3) dot_slice<3>(vs, qs, lane & 7, acc); break;
        case 2: dot_slice<2>(vs, qs, lane & 7, acc); break;
        default: dot_slice<1>(vs, qs, lane & 7, acc);
      }
      if (++k == nk) {  // fold the pass into the running minimum, rows in order
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          if (jj < nj && VST_FOLD(p == 0)) {
            const int row = (int)(row0 + (int64_t)p * PASS_ROWS + jj * LANES + lane);
#pragma unroll
            for (int i2 = 0; i2 < NQ; ++i2) {
              const float rank = fmaf(ra[jj], acc[jj][i2], rb[jj]);
              if (rank < best[i2]) {  // strict: the first (smallest) row keeps ties
                best[i2] = rank;
                best_row[i2] = row;
              }
            }
          }
#pragma unroll
          for (int i2 = 0; i2 < NQ; ++i2) acc[jj][i2] = 0.f;
        }
        k = 0;
        ++p;
      }
    }
    ring.consumed += total;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int n = group * NQ + i;
      if (n < nqt) {
        out_rank[n * out_pitch + lane] = best[i];
        out_row[n * out_pitch + lane] = best_row[i];
      }
    }
  }
};

}  // namespace vst
