// Device code shared by the rank-scan kernels (fused_scan.cu,
// grouped_scan.cu, partition_scan.cu).
//
// Every kernel computes the same thing for a group of stored rows and a set
// of query rows: the affine rank r = a[row] * (q . v[row]) + b[row] of every
// (query, row) pair, folded to 128 candidates per query: candidate `lane`
// is the row with the smallest rank among the group's rows whose offset in
// the group is == lane (mod 128), ties going to the smaller row. Dead rows
// carry b = 1e30 and so never win against a live one.
//
// Design (a simple, correct first kernel; no wgmma or TMA yet):
// - a block has 128 threads, one per lane, and a tile of NQ query rows
//   (QT = 16 by default; 1 in the partition scan, where each query reads
//   rows of its own), staged once in shared memory as f32 [NQ][dp]. The
//   query type (stage_queries) and the storage type (scan_rows) are
//   template parameters of their own: the IVF engine's I8 storage is
//   scanned by bf16 queries;
// - the block walks the group 256 rows at a time; each tile is copied to
//   shared memory DK dimensions at a time with coalesced loads of 8
//   elements (16 bytes of f16/bf16, 8 bytes of int8; converted to f32 with
//   the intrinsics), so the global reads are whole cache lines;
// - thread `lane` then takes rows `lane` and `lane + 128` of the tile (both
//   its lane's) from shared memory (rows padded by 4 floats: conflict-free
//   16-byte reads) and accumulates 2 x NQ dot products in f32 registers
//   against the query tile (shared-memory broadcasts, each used for both
//   rows). Products of f16/bf16 values, and of a bf16 query with an int8
//   row, are exact in f32, and F32 storage keeps full f32 precision: no
//   TF32 anywhere;
// - the running (min rank, row) per query stays in registers, rows in
//   increasing order, and each thread writes its NQ candidates at the end
//   (coalesced across lanes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace vst {

constexpr int LANES = 128;  // threads per block, candidates per group
constexpr int QT = 16;      // query rows per block (default tile)
constexpr int DK = 32;      // dimensions per staged row tile
constexpr int ROW_PITCH = DK + 4;  // floats per staged row (bank-conflict pad)
constexpr int TILE_ROWS = 2 * LANES;  // rows per staged tile: two per thread

// dynamic shared memory of a block: query tile of nq rows + one row tile
inline size_t smem_bytes(int dp, int nq = QT) {
  return sizeof(float) * (nq * dp + TILE_ROWS * ROW_PITCH);
}

// storage types; I8 rows are scanned by bf16 queries (grouped scan only)
enum DType : int { F32 = 0, F16 = 1, BF16 = 2, I8 = 3 };

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 4);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
}

__device__ __forceinline__ void load8(const __half* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// int8 rows: one 8-byte load, each value converted to f32 (exact)
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 lo = *reinterpret_cast<const char4*>(&u.x);
  const char4 hi = *reinterpret_cast<const char4*>(&u.y);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage `nq` query rows (nq <= NQ) into shared memory as f32 [NQ][dp];
// rows past nq are zero (their candidates are never written).
template <int NQ = QT, typename T>
__device__ void stage_queries(const T* __restrict__ q, int nq, int dp,
                              float* __restrict__ qs) {
  for (int i = threadIdx.x; i < NQ * dp; i += blockDim.x) {
    const int row = i / dp;
    qs[i] = row < nq ? to_f32(q[(int64_t)row * dp + (i - row * dp)]) : 0.f;
  }
}

// Accumulate the dot products of this thread's R staged rows (R = 1 or 2)
// with the NQ staged queries over dimensions [k0, k0 + width).
template <int R, int NQ>
__device__ __forceinline__ void dot_tile(const float* __restrict__ qs,
                                        const float* __restrict__ vs, int dp,
                                        int k0, int width,
                                        float (&acc)[2][NQ]) {
  const float* row0 = vs + threadIdx.x * ROW_PITCH;
  const float* row1 = row0 + LANES * ROW_PITCH;
  for (int k = 0; k < width; k += 4) {
    const float4 v0 = *reinterpret_cast<const float4*>(row0 + k);
    float4 v1;
    if (R == 2) v1 = *reinterpret_cast<const float4*>(row1 + k);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(qs + i * dp + k0 + k);
      // one f32 FMA chain per (row, query), dimensions in order
      acc[0][i] = fmaf(q.w, v0.w, fmaf(q.z, v0.z, fmaf(q.y, v0.y, fmaf(q.x, v0.x, acc[0][i]))));
      if (R == 2)
        acc[1][i] = fmaf(q.w, v1.w, fmaf(q.z, v1.z, fmaf(q.y, v1.y, fmaf(q.x, v1.x, acc[1][i]))));
    }
  }
}

// Scan rows [row0, row0 + nrows) (nrows a multiple of LANES) of storage
// type T against the staged queries `qs`, using `vs` [TILE_ROWS][ROW_PITCH]
// as the row tile; returns each query's winner among this thread's rows.
template <typename T, int NQ>
__device__ void scan_rows(const float* __restrict__ qs, float* __restrict__ vs,
                          const T* __restrict__ vectors,
                          const float* __restrict__ a,
                          const float* __restrict__ b, int64_t row0,
                          int nrows, int dp, float (&best)[NQ],
                          int (&best_row)[NQ]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    best[i] = CUDART_INF_F;
    best_row[i] = (int)(row0 + lane);
  }
  for (int r0 = 0; r0 < nrows; r0 += TILE_ROWS) {
    const int64_t tile = row0 + r0;
    const int rows = min(TILE_ROWS, nrows - r0);  // LANES or TILE_ROWS
    float acc[2][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) acc[0][i] = acc[1][i] = 0.f;
    for (int k0 = 0; k0 < dp; k0 += DK) {
      const int width = min(DK, dp - k0);  // a multiple of 8
      const int chunks = width / 8;          // 8-element chunks per row
      __syncthreads();  // the previous tile is consumed
      for (int c = lane; c < rows * chunks; c += LANES) {
        const int r = c / chunks;
        const int k = (c - r * chunks) * 8;
        float x[8];
        load8(vectors + (tile + r) * dp + k0 + k, x);
        float4* dst = reinterpret_cast<float4*>(vs + r * ROW_PITCH + k);
        dst[0] = make_float4(x[0], x[1], x[2], x[3]);
        dst[1] = make_float4(x[4], x[5], x[6], x[7]);
      }
      __syncthreads();
      if (rows == TILE_ROWS) {
        dot_tile<2, NQ>(qs, vs, dp, k0, width, acc);
      } else {
        dot_tile<1, NQ>(qs, vs, dp, k0, width, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // rows in increasing order
      if (j * LANES >= rows) break;
      const int64_t row = tile + j * LANES + lane;
      const float ra = a[row];
      const float rb = b[row];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float rank = fmaf(ra, acc[j][i], rb);
        if (rank < best[i]) {  // strict: the first (smallest) row keeps ties
          best[i] = rank;
          best_row[i] = (int)row;
        }
      }
    }
  }
}

// Raise the dynamic shared-memory limit of `kernel` when the query tile
// needs more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace vst
