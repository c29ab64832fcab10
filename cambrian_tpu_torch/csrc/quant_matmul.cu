// Weight-only int8 / int4 dequant-matmuls for Hopper (sm_90a), with a plain C
// interface that cambrian_tpu_torch/ops/quant.py loads through ctypes.
//
// out[M, N] = x[M, K] @ dequant(w), in x's dtype (bf16 or fp32), with an fp32
// accumulator. Three modes, one per TPU kernel of cambrian_tpu/ops/quant.py:
//
//   mode 0, K3  (replaces _q_matmul_kernel, reached from int8_matmul):
//       w int8 [K, N], scale fp32 [N]. int8 widens exactly to fp32; the
//       per-column scale multiplies the fp32 accumulator once, in the
//       epilogue, before the cast to x's dtype.
//   mode 1, K4  (replaces _q4_matmul_kernel_v3, reached from int4_matmul):
//       w nibble-packed int4 [K/2, N] (byte r holds rows 2r and 2r+1 as its
//       low and high nibble), scale fp32 [K/group, N]. The nibbles are
//       sign-extended with integer shifts and converted exactly to fp32
//       (every int4 value is exact in bf16 too, so this gives the values of
//       the TPU kernel's "convert", "via_int8" and "magic" variants alike).
//       Partial sums over rows of one scale group are kept in fp32 and
//       added as acc += part * scale[g, n].
//   mode 2, K4b / K4c (replaces _q4_matmul_kernel_v2 and _q4_matmul_kernel,
//       selected by CAMBRIAN_INT4_V2=1 / CAMBRIAN_INT4_V1=1): the same
//       function with the scale applied to the weights: the scale is rounded
//       to x's dtype, q * scale is rounded to x's dtype, and one fp32
//       accumulation runs over K. K4c's even/odd split of x only spared the
//       TPU compiler a stride-2 lane slice; here the two nibbles of a byte
//       are two registers, so K4c is this mode too.
//
// Decode (M <= 8) is a GEMV: the weight read is all the work (int8: K*N
// bytes, int4: K*N/2 bytes plus the fp32 scales) and the memory rate bounds
// it. Three kernels, chosen by _gemv_plan in ops/quant.py:
//   - gemv_m1_kernel<mode> takes bf16 x at M = 1 in every mode (every
//     decode step of generate / generate_stream under load_8bit / load_4bit,
//     and under CAMBRIAN_INT4_V2=1 / CAMBRIAN_INT4_V1=1) where the operands
//     allow 16-byte loads (N % 16 == 0, K % 8 == 0, 16-byte-aligned x,
//     weights and scales; int4 groups of a multiple of 128 rows, or one
//     group over a K of a multiple of 128). A thread-block cluster of 2-8
//     blocks owns a slab of 64 or 128 bytes of every weight row (mode 2:
//     128); its blocks split K, their warps split it again, each lane
//     streams 16 bytes of a row (ld.global.nc.L1::no_allocate) with 8 rows
//     in flight, and the blocks' sums meet in distributed shared memory, in
//     rank order: one launch, no workspace, no atomics. Modes 0 and 1 widen
//     the weights to fp32 without I2F and multiply-add on the CUDA cores;
//     mode 2 rounds q * bf16(scale) to bf16 (HMUL2) and runs the products on
//     the tensor cores (mma.sync m16n8k16 with x in one column of B): the
//     scale on the weights costs two more instructions an element, and int4
//     at M = 1 is issue-bound. The plan, not this file, picks the launch
//     shape; the C entry refuses any shape the plan would not give.
//   - gemv_m8_kernel<mode, MT, W> takes bf16 x at M = 2..8 (a continuous-
//     batching decode step runs every projection at M = its slots) on the
//     same operands, with x's rows 16-byte aligned (ldx % 8 == 0): the same
//     cluster split of K, 64- or 128-byte slabs (W = 8 or 16 bytes a lane),
//     every mode's products on mma.sync m16n8k16 with the M rows of x
//     (zero-padded to MT = 2, 4 or 8 in shared memory) in M of B's 8
//     columns, so that every weight byte is read once for all rows and the
//     instructions a weight do not grow with M (see the kernel's note).
//   - gemv_kernel takes the rest (fp32, other operands).
//     It gives each block a 32-column slab of N and loops over all of K
//     inside the block: 4 threads cover the slab along N with 8-byte loads
//     (8 columns each), 64 such K slices split the rows, each keeping 8 or 16
//     row loads in flight, and the slices are summed in registers (warp
//     shuffles) and shared memory at the end. No K split across blocks.
//
// Prefill (M = 645-659 on the 8B path) is bound by operations: the seven
// projections of a layer are 2 M N K = 281.4 GFLOP at M = 645, 9.103 ms a
// request (32 layers) at the bf16 tensor-core peak; the weight bytes (int8
// 0.218 GB a layer) take under a quarter of that at the memory rate. With
// bf16 x and operands TMA can address, gemm_wgmma_kernel runs it on wgmma:
//   - a block owns a 128 x BN output tile (BN = 128, or 64 where blocks of
//     128 columns would not give every SM one; pick_bn) and walks K in
//     64-row tiles through a ring of 4 stages in shared memory;
//   - one producer warp loads each stage by TMA, completing on the stage's
//     mbarrier: the x tile (bf16, K-major, 128-byte swizzle), the raw weight
//     tile (int8 [64, BN] or packed int4 [32, BN] bytes, no swizzle) and, for
//     int4, the tile's row of BN scales (a 64-row tile lies in one group);
//   - two consumer warpgroups, 64 rows of x each, issue the tile's four
//     m64nBNk16 wgmma (x K-major as A, the bf16 weight tile MN-major as B,
//     fp32 accumulators in registers) and, while those run, dequantize the
//     next tile's raw weights to bf16 in the swizzled MN-major layout wgmma
//     reads with the transpose bit, each thread 16 bytes of the raw tile at a
//     time, with exact bit tricks (int8x2_to_bf16, int4x8_to_bf16: the
//     integer in the mantissa of bf16 128.0, less a bf16 constant; checked
//     for every input value by the card tests). Mode 2 then multiplies by
//     the scale in bf16 (one rounding of q * bf16(scale));
//   - one wgmma group stays in flight while the next is issued; a warp
//     releases a stage to the producer once its products have completed;
//   - mode 1 accumulates each scale group's products into a second fp32
//     accumulator (the group's first wgmma overwrites it) and, after the
//     group's last tile, waits and adds part * scale[g, n] into acc; a group
//     of 128 rows is two tiles, so the wait falls every second tile;
//   - the epilogue applies mode 0's scale and stores bf16 pairs.
// Blocks run M-tile first (blockIdx.x), so the M tiles that share a weight
// tile run together and the weights come from device memory once.
// Tiles and waves on 132 SMs (one block an SM) at M = 645 (6 M tiles, the
// last holding 5 rows): q_proj, o_proj (N 4096) and down_proj (K 14336, N
// 4096): 32 x 6 = 192 blocks of BN 128, 1.45 waves; k_proj, v_proj (N 1024):
// 16 x 6 = 96 blocks of BN 64, 0.73 wave; gate_proj, up_proj (N 14336):
// 112 x 6 = 672 blocks of BN 128, 5.09 waves.
// What holds it well below the tensor-core peak (PERF.md has the rates):
// without the dequantization the same loop is faster but still far from
// the peak (the x and weight tiles, 24 KB a tile read from L2, likely near
// its rate on the MLP shapes), and the dequantization sits between one
// tile's products and the next. Tried on the card and slower or no faster:
// 256 columns for int8 and mode 2 (a little faster, but spills), two tiles
// dequantized ahead, a dequantizing warpgroup of its own (128 threads
// convert too slowly), x multicast to clusters of two blocks.
// TMA needs 16-byte-aligned bases and row strides: x's base and row stride,
// the weights' and scales' bases and N % 16 == 0; the int4 modes also need a
// scale group of a multiple of 64 rows, or one group over K. Every main-path
// shape satisfies this. Operands that do not (the card tests' N = 20, 72 and
// 100, x offset by 4 elements) take gemm_tc_kernel: mma.sync m16n8k16 on
// 128 x 128 tiles, 32-row K tiles dequantized to bf16 in shared memory with
// the next tile's loads staged in registers.
// fp32 x takes a SIMT tiled product (64 x 64 tiles, 4 x 4 outputs per
// thread) on the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kInt8 = 0;
constexpr int kInt4 = 1;
constexpr int kInt4ScaleOnWeights = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v rounded to T (nearest even), returned in fp32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// signed byte c (0..3) of a little-endian 32-bit word
__device__ __forceinline__ int byte_of(uint32_t word, int c) {
  return (int)(int8_t)(uint8_t)(word >> (8 * c));
}
// the two int4 values of a packed byte b (sign-extended to int)
__device__ __forceinline__ int low_nibble(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int high_nibble(int b) { return b >> 4; }

struct Args {
  const void* x;       // [M, K], unit stride along K
  int64_t ldx;         // row stride of x, in elements
  const int8_t* w;     // int8 [K, N] (mode 0) or packed int4 [K/2, N], contiguous
  const float* scale;  // [N] (mode 0) or [K/group, N], contiguous
  void* out;           // [M, N] contiguous, x's dtype
  int M, N, K, group;
  int vec;             // 1: rows of w may be read as aligned 8-byte words
  int xvec;            // 1: runs of 8 elements of x may be read as aligned 16-byte words
};

// NW 4-byte words of stored row r from column c on, zero past column N
template <int NW>
__device__ __forceinline__ void load_row(const Args& a, int r, int c, uint32_t (&words)[NW]) {
  const int8_t* p = a.w + (int64_t)r * a.N + c;
  if (a.vec && c + 4 * NW <= a.N) {
    if constexpr (NW == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      words[0] = v.x;
      words[1] = v.y;
    } else {
      words[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (c + 4 * i + b < a.N) v |= (uint32_t)(uint8_t)p[4 * i + b] << (8 * b);
      }
      words[i] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV: M <= 8
// ---------------------------------------------------------------------------

constexpr int kGvThreads = 256;
constexpr int kGvLanesN = 4;                           // threads along N per K slice
constexpr int kGvCols = 8;                             // columns per thread
constexpr int kGvBlockN = kGvLanesN * kGvCols;         // 32 columns per block
constexpr int kGvSlices = kGvThreads / kGvLanesN;      // 64 K slices per block

template <typename T, int MODE, int MMAX>
__global__ void __launch_bounds__(kGvThreads) gemv_kernel(Args a) {
  // stored rows per slice step: more loads in flight where registers allow
  constexpr int kGvChunk = MMAX <= 2 ? 16 : 8;
  const T* X = static_cast<const T*>(a.x);
  const int tid = threadIdx.x;
  const int ln = tid % kGvLanesN;
  const int slice = tid / kGvLanesN;
  const int c0 = blockIdx.x * kGvBlockN + ln * kGvCols;
  const int rows = MODE == kInt8 ? a.K : a.K / 2;
  const int n_chunks = (rows + kGvChunk - 1) / kGvChunk;

  float acc[MMAX][kGvCols];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) acc[m][c] = 0.f;

  if (c0 < a.N) {
    for (int ch = slice; ch < n_chunks; ch += kGvSlices) {
      const int r0 = ch * kGvChunk;
      uint32_t wv[kGvChunk][2];
#pragma unroll
      for (int i = 0; i < kGvChunk; ++i) {
        if (r0 + i < rows) {
          load_row<2>(a, r0 + i, c0, wv[i]);
        } else {
          wv[i][0] = 0;
          wv[i][1] = 0;
        }
      }
      if constexpr (MODE == kInt8) {
#pragma unroll
        for (int i = 0; i < kGvChunk; ++i) {
          const int k = r0 + i;
          float xv[MMAX];
#pragma unroll
          for (int m = 0; m < MMAX; ++m)
            xv[m] = (m < a.M && k < a.K) ? to_f32(X[m * a.ldx + k]) : 0.f;
#pragma unroll
          for (int c = 0; c < kGvCols; ++c) {
            const float w = (float)byte_of(wv[i][c >> 2], c & 3);
#pragma unroll
            for (int m = 0; m < MMAX; ++m) acc[m][c] = fmaf(xv[m], w, acc[m][c]);
          }
        }
      } else {
        // the chunk's 2 * kGvChunk rows of K lie in one scale group (a group
        // is K or a multiple of 32 rows)
        const int g = (2 * r0) / a.group;
        float s[kGvCols];
#pragma unroll
        for (int c = 0; c < kGvCols; ++c) {
          const int col = c0 + c;
          s[c] = col < a.N ? __ldg(a.scale + (int64_t)g * a.N + col) : 0.f;
          if constexpr (MODE == kInt4ScaleOnWeights) s[c] = round_to<T>(s[c]);
        }
        float part[MMAX][kGvCols];
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
#pragma unroll
          for (int c = 0; c < kGvCols; ++c) part[m][c] = 0.f;
#pragma unroll
        for (int i = 0; i < kGvChunk; ++i) {
          const int k = 2 * (r0 + i);  // K is even: k < K implies k + 1 < K
          float x0[MMAX], x1[MMAX];
#pragma unroll
          for (int m = 0; m < MMAX; ++m) {
            const bool in = m < a.M && k < a.K;
            x0[m] = in ? to_f32(X[m * a.ldx + k]) : 0.f;
            x1[m] = in ? to_f32(X[m * a.ldx + k + 1]) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < kGvCols; ++c) {
            const int b = byte_of(wv[i][c >> 2], c & 3);
            float lo = (float)low_nibble(b), hi = (float)high_nibble(b);
            if constexpr (MODE == kInt4ScaleOnWeights) {
              lo = round_to<T>(lo * s[c]);
              hi = round_to<T>(hi * s[c]);
#pragma unroll
              for (int m = 0; m < MMAX; ++m)
                acc[m][c] = fmaf(x1[m], hi, fmaf(x0[m], lo, acc[m][c]));
            } else {
#pragma unroll
              for (int m = 0; m < MMAX; ++m)
                part[m][c] = fmaf(x1[m], hi, fmaf(x0[m], lo, part[m][c]));
            }
          }
        }
        if constexpr (MODE == kInt4) {
#pragma unroll
          for (int m = 0; m < MMAX; ++m)
#pragma unroll
            for (int c = 0; c < kGvCols; ++c) acc[m][c] = fmaf(part[m][c], s[c], acc[m][c]);
        }
      }
    }
  }

  // sum the eight K slices of a warp (lane bits 2 to 4), then the 8 warps
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int off = kGvLanesN; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[m][c] = v;
    }
  constexpr int kWarps = kGvThreads / 32;
  __shared__ float red[kWarps][MMAX][kGvBlockN];
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kGvLanesN) {
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
#pragma unroll
      for (int c = 0; c < kGvCols; ++c) red[warp][m][lane * kGvCols + c] = acc[m][c];
  }
  __syncthreads();
  T* O = static_cast<T*>(a.out);
  for (int idx = tid; idx < MMAX * kGvBlockN; idx += kGvThreads) {
    const int m = idx / kGvBlockN, cl = idx % kGvBlockN;
    const int col = blockIdx.x * kGvBlockN + cl;
    if (m >= a.M || col >= a.N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][m][cl];
    if constexpr (MODE == kInt8) v *= __ldg(a.scale + col);
    store_as(O + (int64_t)m * a.N + col, v);
  }
}

// ---------------------------------------------------------------------------
// GEMM: M > 8
// ---------------------------------------------------------------------------

constexpr int kGmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kGmBM = 64;
constexpr int kGmBN = 64;
constexpr int kGmBK = 32;        // rows of K per tile (16 packed rows in int4)

template <typename T, int MODE>
__global__ void __launch_bounds__(kGmThreads) gemm_kernel(Args a) {
  __shared__ __align__(16) float xs[kGmBK][kGmBM + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[kGmBK][kGmBN];      // dequantized weight tile
  const T* X = static_cast<const T*>(a.x);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kGmBM, n0 = blockIdx.x * kGmBN;

  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < a.K; k0 += kGmBK) {
#pragma unroll
    for (int i = 0; i < kGmBM * kGmBK / kGmThreads; ++i) {
      const int idx = tid + i * kGmThreads;
      const int mm = idx / kGmBK, kk = idx % kGmBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < a.M && k < a.K) ? to_f32(X[(int64_t)m * a.ldx + k]) : 0.f;
    }
    // the tile's rows of K lie in one scale group (group % 32 == 0 or group == K)
    const int g = MODE == kInt8 ? 0 : k0 / a.group;
    if constexpr (MODE == kInt8) {
      const int kk = tid / 8, c = (tid % 8) * 8;  // 32 rows x 8 threads x 8 bytes
      uint32_t wv[2] = {0u, 0u};
      if (k0 + kk < a.K && n0 + c < a.N) load_row<2>(a, k0 + kk, n0 + c, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[kk][c + j] = (float)byte_of(wv[j >> 2], j & 3);
    } else {
      const int rr = tid / 16, c = (tid % 16) * 4;  // 16 packed rows x 16 threads x 4 bytes
      const int r = k0 / 2 + rr;
      uint32_t wv[1] = {0u};
      if (r < a.K / 2 && n0 + c < a.N) load_row<1>(a, r, n0 + c, wv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = byte_of(wv[0], j);
        float lo = (float)low_nibble(b), hi = (float)high_nibble(b);
        if constexpr (MODE == kInt4ScaleOnWeights) {
          const int col = n0 + c + j;
          const float sc =
              col < a.N ? round_to<T>(__ldg(a.scale + (int64_t)g * a.N + col)) : 0.f;
          lo = round_to<T>(lo * sc);
          hi = round_to<T>(hi * sc);
        }
        ws[2 * rr][c + j] = lo;
        ws[2 * rr + 1][c + j] = hi;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGmBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == kInt4)
            part[i][j] = fmaf(ar[i], br[j], part[i][j]);
          else
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
    }
    if constexpr (MODE == kInt4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        const float s = col < a.N ? __ldg(a.scale + (int64_t)g * a.N + col) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
          part[i][j] = 0.f;
        }
      }
    }
    __syncthreads();
  }

  T* O = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.N) continue;
      float v = acc[i][j];
      if constexpr (MODE == kInt8) v *= __ldg(a.scale + n);
      store_as(O + (int64_t)m * a.N + n, v);
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync GEMM: M > 8, bf16 x that gemm_wgmma_kernel does not take
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;        // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int kTcBM = 128;
constexpr int kTcBN = 128;
constexpr int kTcBK = 32;              // rows of K per tile (16 packed rows in int4)
constexpr int kTcLd = kTcBK + 8;       // smem row: 40 bf16 = 80 bytes, conflict-free fragments

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The next tile's global data, staged in registers while the current tile
// is multiplied: 16 bf16 of one x row, and 8 columns of one pair of K rows
// (two int8 rows, or one packed int4 row).
struct TcStage {
  uint4 x[2];
  uint32_t w[2][2];
};

template <int MODE>
__device__ __forceinline__ void tc_load(const Args& a, int m0, int n0, int k0, TcStage& st) {
  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(a.x);
  const int tid = threadIdx.x;
  const int xr = tid >> 1, xk = (tid & 1) * 16;  // 128 rows x 2 halves of 16
  const int m = m0 + xr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + xk + 8 * h;
    if (a.xvec) {  // K % 8 == 0: a run of 8 is all in or all out
      st.x[h] = (m < a.M && k < a.K)
                    ? __ldg(reinterpret_cast<const uint4*>(X + m * a.ldx + k))
                    : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = (m < a.M && k + 2 * e < a.K) ? to_f32(X[m * a.ldx + k + 2 * e]) : 0.f;
        const float hi =
            (m < a.M && k + 2 * e + 1 < a.K) ? to_f32(X[m * a.ldx + k + 2 * e + 1]) : 0.f;
        v[e] = pack_bf16x2(lo, hi);
      }
      st.x[h] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  // K-row pair r (the fastest index, for conflict-free smem stores) and 8 columns
  const int r = tid & 15, c = n0 + (tid >> 4) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.w[h][0] = 0u;
    st.w[h][1] = 0u;
  }
  if constexpr (MODE == kInt8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 2 * r + h;
      if (k < a.K && c < a.N) load_row<2>(a, k, c, st.w[h]);
    }
  } else {
    const int rp = k0 / 2 + r;
    if (rp < a.K / 2 && c < a.N) load_row<2>(a, rp, c, st.w[0]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kTcThreads) gemm_tc_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 As[kTcBM][kTcLd];  // x tile, [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kTcBN][kTcLd];  // weight tile, [n][k]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column-pair of this lane
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0.f;
      }

  TcStage st;
  tc_load<MODE>(a, m0, n0, 0, st);
  for (int k0 = 0; k0 < a.K; k0 += kTcBK) {
    // registers -> shared memory, the weights dequantized to bf16 [n][k]
    {
      const int xr = tid >> 1, xk = (tid & 1) * 16;
      *reinterpret_cast<uint4*>(&As[xr][xk]) = st.x[0];
      *reinterpret_cast<uint4*>(&As[xr][xk + 8]) = st.x[1];
      const int r = tid & 15, c = (tid >> 4) * 8;
      const int grp = MODE == kInt8 ? 0 : k0 / a.group;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float lo, hi;
        if constexpr (MODE == kInt8) {
          lo = (float)byte_of(st.w[0][j >> 2], j & 3);
          hi = (float)byte_of(st.w[1][j >> 2], j & 3);
        } else {
          const int b = byte_of(st.w[0][j >> 2], j & 3);
          lo = (float)low_nibble(b);
          hi = (float)high_nibble(b);
          if constexpr (MODE == kInt4ScaleOnWeights) {
            const int col = n0 + c + j;
            const float sc = col < a.N
                ? round_to<__nv_bfloat16>(__ldg(a.scale + (int64_t)grp * a.N + col)) : 0.f;
            lo *= sc;  // rounded to bf16 by the pack below
            hi *= sc;
          }
        }
        *reinterpret_cast<uint32_t*>(&Bs[c + j][2 * r]) = pack_bf16x2(lo, hi);
      }
    }
    __syncthreads();
    if (k0 + kTcBK < a.K) tc_load<MODE>(a, m0, n0, k0 + kTcBK, st);

#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + i * 16 + gq;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * tq]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * tq]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * tq + 8]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * tq + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + gq;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * tq]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * tq + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == kInt4)
            mma_16816(part[i][j], af[i], bf[j]);
          else
            mma_16816(acc[i][j], af[i], bf[j]);
        }
    }
    if constexpr (MODE == kInt4) {
      // the last tile of a scale group: acc += part * scale[g, n]
      if ((k0 + kTcBK) % a.group == 0 || k0 + kTcBK >= a.K) {
        const int grp = k0 / a.group;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn + j * 8 + 2 * tq + e;
            const float sc = col < a.N ? __ldg(a.scale + (int64_t)grp * a.N + col) : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                acc[i][j][2 * h + e] = fmaf(part[i][j][2 * h + e], sc, acc[i][j][2 * h + e]);
                part[i][j][2 * h + e] = 0.f;
              }
          }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + gq + 8 * h;
        if (m >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * tq + e;
          if (n >= a.N) continue;
          float v = acc[i][j][2 * h + e];
          if constexpr (MODE == kInt8) v *= __ldg(a.scale + n);
          store_as(O + (int64_t)m * a.N + n, v);
        }
      }
}

// ---------------------------------------------------------------------------
// wgmma GEMM: M > 8, bf16 x, TMA-addressable operands (see the note above)
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;                      // x rows per block, 64 per consumer warpgroup
constexpr int kWgBK = 64;                       // K rows per tile (32 packed rows in int4)
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 256;               // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;   // and a producer warp
constexpr int kWgChunkBytes = kWgBK * 128;      // 64 columns of the bf16 weight tile

template <int BN>
struct WgStage {
  __nv_bfloat16 x[kWgBM * kWgBK];  // 128 rows of 128 bytes, 128-byte swizzle (TMA)
  __nv_bfloat16 w[kWgBK * BN];     // BN / 64 chunks of 64 K rows x 128 bytes, 128-byte swizzle
  uint8_t raw[kWgBK * BN];         // int8 [64][BN] or packed int4 [32][BN] (TMA, no swizzle)
};

template <int BN>
struct WgSmem {
  WgStage<BN> st[kWgStages];
  float scale[kWgStages][BN];  // modes 1 and 2: the tile's row of scales (TMA)
  uint64_t full[kWgStages];    // the stage's TMA loads have landed
  uint64_t deq[kWgStages];     // its weights are dequantized (every consumer thread)
  uint64_t empty[kWgStages];   // its products have completed (every consumer warp)
};

template <int BN>
constexpr size_t wg_smem_bytes() {
  return sizeof(WgSmem<BN>) + 1024;  // room to align the base to the 128-byte swizzle's 1024
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two int8 values, in bytes 0 and 2 of p, as a bf16 pair, exactly: the low
// 7 bits in the mantissa of bf16 128.0 (0x4300), less 128.0 (0x4300) or,
// where the sign bit is set, 256.0 (0x4380): 128 + v - 128 = v for v >= 0,
// 128 + (v + 128) - 256 = v for v < 0.
__device__ __forceinline__ uint32_t int8x2_to_bf16(uint32_t p) {
  return bf16x2_sub((p & 0x007F007Fu) | 0x43004300u, (p & 0x00800080u) | 0x43004300u);
}

// Four int8 values (a little-endian word: columns c .. c + 3) as two bf16
// pairs, exactly.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = int8x2_to_bf16(__byte_perm(w, 0, 0x1110));  // bytes 0, 1 to bytes 0, 2
  hi = int8x2_to_bf16(__byte_perm(w, 0, 0x3332));  // bytes 2, 3
}

// A word of four packed int4 bytes (columns c .. c + 3; low nibble row 2r,
// high nibble row 2r + 1) as bf16 pairs of each row, exactly: q + 8 (the
// nibble with its sign bit flipped) in the mantissa of bf16 128.0 (0x4300),
// less 136 (0x4308).
__device__ __forceinline__ void int4x8_to_bf16(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
  constexpr uint32_t kBias = 0x43084308u;
  lo[0] = bf16x2_sub(__byte_perm(l, 0x43434343u, 0x4140), kBias);
  lo[1] = bf16x2_sub(__byte_perm(l, 0x43434343u, 0x4342), kBias);
  hi[0] = bf16x2_sub(__byte_perm(h, 0x43434343u, 0x4140), kBias);
  hi[1] = bf16x2_sub(__byte_perm(h, 0x43434343u, 0x4342), kBias);
}

// 16 bf16 (8 pairs) into row r, columns c .. c + 15 (c % 16 == 0), of the
// swizzled MN-major weight tile: column chunk c / 64, 16-byte group g of a
// 128-byte row stored at g ^ (r % 8).
__device__ __forceinline__ void store_w16(uint8_t* tile, int r, int c, const uint32_t (&o)[8]) {
  uint8_t* row = tile + (c >> 6) * kWgChunkBytes + r * 128;
  const int g = (c & 63) >> 3;
  *reinterpret_cast<uint4*>(row + ((g ^ (r & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(row + (((g + 1) ^ (r & 7)) << 4)) = make_uint4(o[4], o[5], o[6], o[7]);
}

// Dequantize tile u's raw weights to the stage's bf16 tile: wait for its
// loads, convert this thread's share (16 raw bytes at a time), make the
// stores visible to wgmma and arrive on the stage's deq barrier.
template <int MODE, int BN>
__device__ __forceinline__ void dequant_tile(WgSmem<BN>& s, int u, int tid) {
  using namespace hopper;
  const int stage = u % kWgStages;
  mbar_wait(&s.full[stage], (u / kWgStages) & 1);
  constexpr int kRawRows = MODE == kInt8 ? kWgBK : kWgBK / 2;
  constexpr int kSegsPerRow = BN / 16;
  constexpr int kSegs = kRawRows * kSegsPerRow;
  const uint8_t* raw = s.st[stage].raw;
  uint8_t* tile = reinterpret_cast<uint8_t*>(s.st[stage].w);
#pragma unroll
  for (int i = 0; i < (kSegs + kWgConsumers - 1) / kWgConsumers; ++i) {
    const int seg = tid + i * kWgConsumers;
    if (kSegs % kWgConsumers != 0 && seg >= kSegs) break;
    const int r = seg / kSegsPerRow, c = (seg % kSegsPerRow) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + c);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    if constexpr (MODE == kInt8) {
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) int8x4_to_bf16(words[j], o[2 * j], o[2 * j + 1]);
      store_w16(tile, r, c, o);
    } else {
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t l2[2], h2[2];
        int4x8_to_bf16(words[j], l2, h2);
        lo[2 * j] = l2[0];
        lo[2 * j + 1] = l2[1];
        hi[2 * j] = h2[0];
        hi[2 * j + 1] = h2[1];
      }
      if constexpr (MODE == kInt4ScaleOnWeights) {
        // the tile lies in one scale group: q * bf16(scale), rounded once
        // by the bf16 product
        const float4* sc = reinterpret_cast<const float4*>(&s.scale[stage][c]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f = sc[q];
          const uint32_t s01 = pack_bf16(f.x, f.y), s23 = pack_bf16(f.z, f.w);
          lo[2 * q] = bf16x2_mul(lo[2 * q], s01);
          hi[2 * q] = bf16x2_mul(hi[2 * q], s01);
          lo[2 * q + 1] = bf16x2_mul(lo[2 * q + 1], s23);
          hi[2 * q + 1] = bf16x2_mul(hi[2 * q + 1], s23);
        }
      }
      store_w16(tile, 2 * r, c, lo);
      store_w16(tile, 2 * r + 1, c, hi);
    }
  }
  fence_proxy_async();
  mbar_arrive(&s.deq[stage]);
}

// The two consumer warpgroups: products, dequantization, epilogue.
template <int MODE, int BN>
__device__ __forceinline__ void wgmma_consumer(const Args& a, WgSmem<BN>& s, int m0, int n0) {
  using namespace hopper;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = (a.K + kWgBK - 1) / kWgBK;
  const int wg = warp / 4;  // multiplies x rows 64 wg .. 64 wg + 63 of the tile
  float acc[BN / 2];
  float part[MODE == kInt4 ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  dequant_tile<MODE, BN>(s, 0, tid);
  int released = 0;  // tiles whose stage this warp has released
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kWgStages;
    const int k0 = t * kWgBK;
    mbar_wait(&s.deq[stage], (t / kWgStages) & 1);
    const __nv_bfloat16* xt = s.st[stage].x + wg * 64 * kWgBK;
    const __nv_bfloat16* wt = s.st[stage].w;
    if constexpr (MODE == kInt4) {
      const int first = k0 % a.group == 0;  // the group's first tile overwrites part
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_ss_mn(part, desc_k_major<64>(xt, kk), desc_mn_major<BN>(wt, kk), kk > 0 || !first);
      wgmma_commit();
      fence_regs(part);
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_ss_mn(acc, desc_k_major<64>(xt, kk), desc_mn_major<BN>(wt, kk), 1);
      wgmma_commit();
      fence_regs(acc);
    }
    if (t + 1 < tiles) dequant_tile<MODE, BN>(s, t + 1, tid);
    bool group_end = false;  // mode 1: the last tile of a scale group
    if constexpr (MODE == kInt4) group_end = (k0 + kWgBK) % a.group == 0 || k0 + kWgBK >= a.K;
    int done;  // tiles whose products have completed
    if (group_end) {
      // acc += part * scale[g, n], the scales from the stage (zero past N)
      wgmma_wait<0>();
      if constexpr (MODE == kInt4) {
        fence_regs(part);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 sc =
              *reinterpret_cast<const float2*>(&s.scale[stage][8 * j + 2 * (lane % 4)]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[4 * j + 2 * r] = fmaf(part[4 * j + 2 * r], sc.x, acc[4 * j + 2 * r]);
            acc[4 * j + 2 * r + 1] = fmaf(part[4 * j + 2 * r + 1], sc.y, acc[4 * j + 2 * r + 1]);
          }
        }
      }
      done = t + 1;
    } else {
      wgmma_wait<1>();
      done = t;
    }
    // release: one arrival a warp on the stage's empty barrier
    for (; released < done; ++released) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[released % kWgStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.out);
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= a.N) continue;
    float2 sc = make_float2(1.f, 1.f);
    if constexpr (MODE == kInt8) sc = __ldg(reinterpret_cast<const float2*>(a.scale + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.M)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row * a.N + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * sc.x, acc[4 * j + 2 * r + 1] * sc.y);
    }
  }
}

template <int MODE, int BN>
__global__ void __launch_bounds__(kWgThreads, 1) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_s, Args a) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  WgSmem<BN>& s = *reinterpret_cast<WgSmem<BN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.deq[i], kWgConsumers);
      mbar_init(&s.empty[i], kWgConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {
    // producer: x, raw weight and scale tiles through the ring
    if (lane == 0) {
      constexpr uint32_t kTx = kWgBM * kWgBK * 2 + (MODE == kInt8 ? kWgBK : kWgBK / 2) * BN +
                               (MODE == kInt8 ? 0 : BN * 4);
      const int tiles = (a.K + kWgBK - 1) / kWgBK;
      for (int t = 0; t < tiles; ++t) {
        const int stage = t % kWgStages, k0 = t * kWgBK;
        mbar_wait(&s.empty[stage], ((t / kWgStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[stage], kTx);
        tma_load_2d(s.st[stage].x, &tm_x, &s.full[stage], k0, m0);
        tma_load_2d(s.st[stage].raw, &tm_w, &s.full[stage], n0, MODE == kInt8 ? k0 : k0 / 2);
        if constexpr (MODE != kInt8)
          tma_load_2d(s.scale[stage], &tm_s, &s.full[stage], n0, k0 / a.group);
      }
    }
  } else {
    wgmma_consumer<MODE, BN>(a, s, m0, n0);
  }
}

// Whether gemm_wgmma_kernel takes the operands: TMA's 16-byte alignment of
// x's base and row stride, of the weights' base and row (N bytes); for int4,
// scale groups that do not split a 64-row K tile.
bool wgmma_takes(int mode, const Args& a) {
  return reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && a.ldx % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a.w) % 16 == 0 && a.N % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.scale) % 16 == 0 &&
         (mode == kInt8 || a.group % kWgBK == 0 || a.group == a.K);
}

// The output tile's width: 64 where blocks of 128 columns would not give
// every SM of the card one, else 128.
int pick_bn(int m, int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return (long)((m + kWgBM - 1) / kWgBM) * ((n + 127) / 128) < sms ? 64 : 128;
}

template <int MODE, int BN>
int launch_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap tm_x, tm_w, tm_s;
  const uint64_t w_rows = MODE == kInt8 ? a.K : a.K / 2;
  const uint64_t s_rows = MODE == kInt8 ? 1 : a.K / a.group;
  using hopper_host::tile_map_2d;
  if (!tile_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, (uint64_t)a.ldx * 2,
                   kWgBK, kWgBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.N, w_rows, a.N, BN,
                   MODE == kInt8 ? kWgBK : kWgBK / 2, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tile_map_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.scale, a.N, s_rows,
                   (uint64_t)a.N * 4, BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_kernel<MODE, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.M + kWgBM - 1) / kWgBM, (a.N + BN - 1) / BN);
  gemm_wgmma_kernel<MODE, BN><<<grid, kWgThreads, smem, st>>>(tm_x, tm_w, tm_s, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMV: M = 1, bf16 x, modes 0-2, split over a thread-block cluster
// ---------------------------------------------------------------------------

// These match GEMV_LOADS, GEMV_MAX_WARPS and GEMV_SMEM_BYTES in ops/quant.py.
constexpr int kM1Loads = 8;              // 16-byte loads of a lane's batch
constexpr int kM1MaxWarps = 8;
constexpr int kM1SmemBytes = 48 * 1024;  // x, the scales of the block's rows and its sums
constexpr int kM1Stage = 2;              // 16-byte loads of x (and scales) a thread sends first

struct M1Args {
  const __nv_bfloat16* x;  // [K], 16-byte aligned
  const uint8_t* w;        // int8 [K, N] or packed int4 [K/2, N], 16-byte aligned
  const float* scale;      // [N] (mode 0) or [K/group, N], 16-byte aligned
  __nv_bfloat16* out;      // [N]
  int N, K, group;
  int slab;                // stored bytes of a row a cluster owns: 64 or 128
  int rows_per_block, rows_per_warp;  // stored rows
};

// the low and high bf16 of a pair as fp32, exactly
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// Byte b of v, a value v_b < 128, as the fp32 128 + v_b, exactly: the byte
// in the top of the mantissa of 128.0f (0x43000000), one byte permute.
__device__ __forceinline__ float nibble_f32(uint32_t v, int b) {
  return __uint_as_float(__byte_perm(v, 0x43u, 0x4055u | (b << 8)));
}

// The rows of scales a block stages: mode 0's one row; mode 1's scale
// groups of the block's rows (one where a group spans K; otherwise the
// block's rows are whole groups).
template <class A>  // M1Args or M8Args
__device__ __host__ __forceinline__ int m1_groups(int mode, const A& a) {
  return mode == kInt8 || a.group == a.K ? 1 : 2 * a.rows_per_block / a.group;
}

// the kernel's shared memory: x of the block's rows, the slab's scales, and
// the sums of the columns the block finishes, from every warp of the cluster
__host__ __forceinline__ size_t m1_smem_bytes(int mode, const M1Args& a, int warps) {
  const size_t x_floats = (size_t)a.rows_per_block * (mode == kInt8 ? 1 : 2);
  return 4 * (x_floats + (size_t)(m1_groups(mode, a) + warps) * a.slab);
}

// Run i of 8 elements of the block's x (i < runs), zero past K.
__device__ __forceinline__ uint4 m1_x_load(const M1Args& a, int k0, int runs, int i) {
  const int k = k0 + 8 * i;
  return i < runs && k < a.K ? __ldg(reinterpret_cast<const uint4*>(a.x + k))
                             : make_uint4(0u, 0u, 0u, 0u);
}

// Run i of x into shared memory: as fp32 (modes 0, 1), or as it is, bf16
// pairs of rows 2r, 2r + 1 (mode 2's mma operand).
template <int MODE>
__device__ __forceinline__ void m1_x_store(float* xs, int i, uint4 v) {
  if constexpr (MODE == kInt4ScaleOnWeights) {
    reinterpret_cast<uint4*>(xs)[i] = v;
  } else {
    float4* dst = reinterpret_cast<float4*>(xs + 8 * i);
    dst[0] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
    dst[1] = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w));
  }
}

// Four scales as staged: fp32 (modes 0, 1), or each rounded to bf16 and held
// twice, as a bf16 pair (mode 2: one HMUL2 scales a column's two rows).
template <int MODE>
__device__ __forceinline__ float4 m1_scale_staged(float4 v) {
  if constexpr (MODE == kInt4ScaleOnWeights) {
    uint32_t p[4];
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(f[i]));
      p[i] = h | (h << 16);
    }
    return make_float4(__uint_as_float(p[0]), __uint_as_float(p[1]), __uint_as_float(p[2]),
                       __uint_as_float(p[3]));
  } else {
    return v;
  }
}

// float4 i (i < n) of the block's scales, row g0 + i / (slab / 4) of the
// [rows, N] scales (mode 0: one row), zero past the last row or past N.
template <class A>  // M1Args or M8Args
__device__ __forceinline__ float4 m1_scale_load(const A& a, int rows, int g0, int slab0, int n,
                                                int i) {
  const int per_group = a.slab / 4;
  const int g = g0 + i / per_group, c = slab0 + 4 * (i % per_group);
  return i < n && g < rows && c < a.N
             ? __ldg(reinterpret_cast<const float4*>(a.scale + (int64_t)g * a.N + c))
             : make_float4(0.f, 0.f, 0.f, 0.f);
}

// 16 bytes that are read once: past L1, not kept there
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// One batch of a lane's loads: stored rows rb + u * step at its 16 columns,
// zero past the warp's last row or past N.
__device__ __forceinline__ void m1_load(const M1Args& a, bool live, int col, int rb, int step,
                                        int end, uint4 (&buf)[kM1Loads]) {
#pragma unroll
  for (int u = 0; u < kM1Loads; ++u) {
    const int r = rb + u * step;
    buf[u] = live && r < end ? ld_stream(a.w + (int64_t)r * a.N + col) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Mode 2's 8 mma accumulators of the lane's column pairs (m16n8k16 C
// fragments; row 0, n = 0 holds the sums); empty in modes 0 and 1, where
// even an unused member changed ptxas' register allocation.
template <int MODE>
struct M1MmaSums {};
template <>
struct M1MmaSums<kInt4ScaleOnWeights> {
  float mma[8][4] = {};
};

// A lane's sums: 16 columns' fp32 accumulators and, in mode 1, the current
// scale group's partials, its sum of x, its batches so far and its scales.
template <int MODE>
struct M1Sums : M1MmaSums<MODE> {
  float acc[16] = {};
  float part[MODE == kInt4 ? 16 : 1] = {};
  float xsum = 0.f;
  int group_batch = 0;
  const float* group_scale = nullptr;  // the lane's 16 columns of the group's staged scales
  int scale_stride = 0;                // floats from one group's staged scales to the next
};

// Mode 2: byte b (b < 4) of the low- and high-nibble words l, h (q + 8 in
// each byte) as the bf16 pair (q of row 2r, q of row 2r + 1) of that column,
// exactly: q + 8 in the mantissa of bf16 128.0, less 136.
__device__ __forceinline__ void int4_pairs(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t z01 = __byte_perm(l, h, 0x5140);  // l0 h0 l1 h1
  const uint32_t z23 = __byte_perm(l, h, 0x7362);  // l2 h2 l3 h3
  constexpr uint32_t kBias = 0x43084308u;
  p[0] = bf16x2_sub(__byte_perm(z01, 0x43u, 0x4140), kBias);
  p[1] = bf16x2_sub(__byte_perm(z01, 0x43u, 0x4342), kBias);
  p[2] = bf16x2_sub(__byte_perm(z23, 0x43u, 0x4140), kBias);
  p[3] = bf16x2_sub(__byte_perm(z23, 0x43u, 0x4342), kBias);
}

// Mode 2: consume one batch on the tensor cores. The lane holds packed rows
// xr0 + 4u (u < kM1Loads) of its 16 columns; loads 2p and 2p + 1 give the K
// rows 2t..2t+1 and 2t+8..2t+9 (t = lane % 4) of one m16n8k16 product a
// column pair: A is the dequantized weights (m = the lane's column chunk
// lane / 4, and that plus 8 for the pair's second column), B holds x in its
// column 0 (lanes 0-3) and zeros elsewhere, so row 0 of each product's C
// gains the pair's sums. Each weight is q * bf16(scale), rounded once by
// the bf16 product, as the plain version (and the TPU kernel) round it.
__device__ __forceinline__ void m1_consume_mma(const float* xs, const uint4 (&buf)[kM1Loads],
                                               int xr0, int step, int group_batches,
                                               M1Sums<kInt4ScaleOnWeights>& s) {
  const int lane = threadIdx.x % 32;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
  const uint4* sp = reinterpret_cast<const uint4*>(s.group_scale);
  uint32_t sc[16];  // the lane's 16 columns' bf16 scales, each as a pair
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = sp[q];
    sc[4 * q] = v.x, sc[4 * q + 1] = v.y, sc[4 * q + 2] = v.z, sc[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int p = 0; p < kM1Loads / 2; ++p) {
    const int xr = xr0 + 2 * p * step;  // < rows_per_block: x is zero past K
    const uint32_t b[2] = {lane < 4 ? xw[xr] : 0u, lane < 4 ? xw[xr + step] : 0u};
    const uint32_t r1[4] = {buf[2 * p].x, buf[2 * p].y, buf[2 * p].z, buf[2 * p].w};
    const uint32_t r2[4] = {buf[2 * p + 1].x, buf[2 * p + 1].y, buf[2 * p + 1].z,
                            buf[2 * p + 1].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t p1[4], p2[4];  // columns 4q .. 4q + 3 of the two rows
      int4_pairs(r1[q], p1);
      int4_pairs(r2[q], p2);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p1[c] = bf16x2_mul(p1[c], sc[4 * q + c]);
        p2[c] = bf16x2_mul(p2[c], sc[4 * q + c]);
      }
      // column pairs (4q, 4q + 1) and (4q + 2, 4q + 3): m = g and g + 8
      const uint32_t a0[4] = {p1[0], p1[1], p2[0], p2[1]};
      const uint32_t a1[4] = {p1[2], p1[3], p2[2], p2[3]};
      mma_16816(s.mma[2 * q], a0, b);
      mma_16816(s.mma[2 * q + 1], a1, b);
    }
  }
  if (++s.group_batch == group_batches) {
    s.group_batch = 0;
    s.group_scale += s.scale_stride;
  }
}

// Consume one batch: rows xr0 + u * step of the block's x (u < kM1Loads)
// times the batch's weights; in mode 1, at the end of a scale group or of
// the warp's rows (last), the group's partials times its scales into acc.
template <int MODE>
__device__ __forceinline__ void m1_consume(const float* xs, const uint4 (&buf)[kM1Loads], int xr0,
                                           int step, bool last, int group_batches,
                                           M1Sums<MODE>& s) {
#pragma unroll
  for (int u = 0; u < kM1Loads; ++u) {
    const int xr = xr0 + u * step;  // < rows_per_block: x is zero past K
    const uint32_t words[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
    if constexpr (MODE == kInt8) {
      const float xv = xs[xr];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t lo, hi;
        int8x4_to_bf16(words[q], lo, hi);
        s.acc[4 * q] = fmaf(xv, bf16_lo(lo), s.acc[4 * q]);
        s.acc[4 * q + 1] = fmaf(xv, bf16_hi(lo), s.acc[4 * q + 1]);
        s.acc[4 * q + 2] = fmaf(xv, bf16_lo(hi), s.acc[4 * q + 2]);
        s.acc[4 * q + 3] = fmaf(xv, bf16_hi(hi), s.acc[4 * q + 3]);
      }
    } else {
      const float2 xv = *reinterpret_cast<const float2*>(xs + 2 * xr);  // rows 2r, 2r + 1
      s.xsum += xv.x + xv.y;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // q + 8 of each nibble as a byte: row 2r's (low nibbles) in lo,
        // row 2r + 1's in hi; byte b is column 4 q + b
        const uint32_t v = words[q] ^ 0x88888888u;
        const uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s.part[4 * q + b] =
              fmaf(xv.y, nibble_f32(hi, b), fmaf(xv.x, nibble_f32(lo, b), s.part[4 * q + b]));
      }
    }
  }
  if constexpr (MODE == kInt4) {
    if (++s.group_batch == group_batches || last) {
      // part holds sum x (136 + q) over the group's rows: less 136 sum x
      const float4* sp = reinterpret_cast<const float4*>(s.group_scale);
      const float bias = -136.f * s.xsum;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 sc = sp[q];
        s.acc[4 * q] = fmaf(s.part[4 * q] + bias, sc.x, s.acc[4 * q]);
        s.acc[4 * q + 1] = fmaf(s.part[4 * q + 1] + bias, sc.y, s.acc[4 * q + 1]);
        s.acc[4 * q + 2] = fmaf(s.part[4 * q + 2] + bias, sc.z, s.acc[4 * q + 2]);
        s.acc[4 * q + 3] = fmaf(s.part[4 * q + 3] + bias, sc.w, s.acc[4 * q + 3]);
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) s.part[c] = 0.f;
      s.xsum = 0.f;
      s.group_batch = 0;
      s.group_scale += s.scale_stride;
    }
  }
}

// A cluster owns a slab of `slab` bytes of every stored row (int8: `slab`
// columns; int4: `slab` columns of two K rows). Its blocks split the rows in
// rank order and a block's warps split the block's rows, each in whole
// batches and, in modes 1 and 2, whole scale groups (or units of 64 packed
// rows where one group spans K). A warp's lanes cover slab / 16 lanes of a row,
// 16 bytes each, and 32 / (slab / 16) rows at a time; a lane keeps a batch
// of kM1Loads rows in flight and starts the next batch before it consumes
// the current one (two batches in flight took more registers, so fewer
// blocks fit an SM, and ran slower). x of the block's rows and the slab's
// scales are staged in shared memory, their loads sent ahead of the
// weights'. No I2F: int8 goes to bf16 by the exact bit trick of the wgmma
// GEMM and to fp32 by a shift; each int4 nibble, plus 8, becomes the fp32
// 136 + q by one byte permute, and 136 times the group's sum of x comes off
// its partial (int4 is instruction-bound, and this is the cheapest exact
// widening). 16 fp32 accumulators a lane (mode 1: a group's partial, times
// the group's scale at its end). Mode 2 (slab 128) lays its lanes out for
// m16n8k16 fragments instead and sums on the tensor cores
// (m1_consume_mma), which also adds up the warp's rows. The sums: across a
// warp's rows by shuffles (modes 0, 1); then each warp stores its sums of a column into the shared
// memory of the rank that finishes the column (slab / cluster columns a
// rank), through distributed shared memory, and after one cluster barrier
// each rank adds its columns' sums, rank by rank and warp by warp, in order.
template <int MODE>
__global__ void __launch_bounds__(kM1MaxWarps * 32) gemv_m1_kernel(M1Args a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float m1_smem[];
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warps = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lanes_per_row = a.slab / 16, step = 32 / lanes_per_row;
  const int batch = kM1Loads * step;
  const int rows = MODE == kInt8 ? a.K : a.K / 2;
  const int slab0 = (blockIdx.x / n_ranks) * a.slab;
  // a lane's 16 columns and its row of each step: neighbouring lanes on
  // neighbouring columns (modes 0, 1), or, for mode 2's m16n8k16 fragments,
  // on neighbouring rows (chunk lane / 4, row lane % 4; slab 128)
  constexpr bool kMma = MODE == kInt4ScaleOnWeights;
  const int chunk = kMma ? lane / 4 : lane % lanes_per_row;
  const int col = slab0 + chunk * 16;
  const bool live = col < a.N;
  const int b0 = rank * a.rows_per_block;
  const int w0 = b0 + warp * a.rows_per_warp;
  const int w1 = min(w0 + a.rows_per_warp, rows);  // <= w0: a warp without rows
  const int j = kMma ? lane % 4 : lane / lanes_per_row;

  constexpr int kXPerRow = MODE == kInt8 ? 1 : 2;
  const int xn = kXPerRow * a.rows_per_block;
  // the scales of the slab: mode 0's row; mode 1's groups of the block's rows
  const int groups = m1_groups(MODE, a);
  const int g0 = MODE == kInt8 ? 0 : 2 * b0 / a.group;
  const int scale_rows = MODE == kInt8 ? 1 : a.K / a.group;
  const int share = a.slab / n_ranks;    // columns each rank finishes
  float* xs = m1_smem;                    // x of the block's rows, zero past K
  float* ss = xs + xn;                    // [groups][slab]: the scales, zero past N
  float* sums = ss + groups * a.slab;     // [ranks][warps][share]: sums of this rank's columns
  float4* ss4 = reinterpret_cast<float4*>(ss);

  // x of the block's rows (fp32) and the slab's scales, their first loads
  // sent ahead of the weights' so that they do not queue behind them
  const int xk0 = kXPerRow * b0;
  const int x_runs = xn / 8, n_scales = groups * (a.slab / 4);
  uint4 xv[kM1Stage];
  float4 sv[kM1Stage];
#pragma unroll
  for (int q = 0; q < kM1Stage; ++q) {
    xv[q] = m1_x_load(a, xk0, x_runs, tid + q * blockDim.x);
    sv[q] = m1_scale_load(a, scale_rows, g0, slab0, n_scales, tid + q * blockDim.x);
  }
  uint4 cur[kM1Loads];
  m1_load(a, live, col, w0 + j, step, w1, cur);
#pragma unroll
  for (int q = 0; q < kM1Stage; ++q) {
    const int i = tid + q * blockDim.x;
    if (i < x_runs) m1_x_store<MODE>(xs, i, xv[q]);
    if (i < n_scales) ss4[i] = m1_scale_staged<MODE>(sv[q]);
  }
  for (int i = tid + kM1Stage * blockDim.x; i < x_runs; i += blockDim.x)
    m1_x_store<MODE>(xs, i, m1_x_load(a, xk0, x_runs, i));
  for (int i = tid + kM1Stage * blockDim.x; i < n_scales; i += blockDim.x)
    ss4[i] = m1_scale_staged<MODE>(m1_scale_load(a, scale_rows, g0, slab0, n_scales, i));
  __syncthreads();

  M1Sums<MODE> mine;
  // int4: batches a scale group takes (never, where one group spans K),
  // and the warp's first group's row of the staged scales
  const int group_batches = a.group == a.K ? rows : a.group / 2 / batch;
  if constexpr (MODE != kInt8) {
    mine.group_scale = ss + (2 * w0 / a.group - g0) * a.slab + col - slab0;
    mine.scale_stride = a.slab;
  }
  for (int rb = w0; rb < w1; rb += batch) {
    uint4 nxt[kM1Loads];  // the next batch goes out before this one is consumed
    m1_load(a, live, col, rb + batch + j, step, w1, nxt);
    if constexpr (kMma)
      m1_consume_mma(xs, cur, rb + j - b0, step, group_batches, mine);
    else
      m1_consume<MODE>(xs, cur, rb + j - b0, step, rb + batch >= w1, group_batches, mine);
#pragma unroll
    for (int u = 0; u < kM1Loads; ++u) cur[u] = nxt[u];
  }
  float (&acc)[16] = mine.acc;

  if constexpr (kMma) {
    // row 0 of the products (lanes 0, 4, ..., 28): the sums of the chunk's
    // column pairs, over the warp's rows
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      acc[2 * p] = mine.mma[p][0];
      acc[2 * p + 1] = mine.mma[p][2];
    }
  } else {
    // the warp's rows (lanes step apart share columns)
    for (int off = lanes_per_row; off < 32; off *= 2)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  // each column's sum to the rank that finishes it, through distributed
  // shared memory; no rank reads another's shared memory, so the one
  // cluster barrier (release, then acquire) is all the ordering there is
  if (kMma ? lane % 4 == 0 : lane < lanes_per_row) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // (modes 0, 1: chunk == lane here; the plain lane keeps their code lean)
      const int c = (kMma ? chunk : lane) * 16 + 4 * q, owner = c / share;
      float* dst = cluster.map_shared_rank(sums, owner) + (rank * warps + warp) * share + c % share;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  cluster.sync();
  // every warp of the cluster, rank by rank, in order
  for (int t = tid; t < share; t += blockDim.x) {
    float v = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_ranks * warps; ++i) v += sums[i * share + t];
    const int n = slab0 + rank * share + t;
    if (n < a.N) {
      if constexpr (MODE == kInt8) v *= ss[rank * share + t];
      a.out[n] = __float2bfloat16(v);
    }
  }
}

// Whether a K split is one _gemv_split (ops/quant.py) can give: the blocks
// and warps split the stored rows in whole units (int8: batches; int4:
// scale groups, or 64 packed rows where one group spans K), every rank has
// rows.
bool split_takes(int mode, int k, int group, int slab, int rows_per_block, int rows_per_warp,
                 int cluster, int warps) {
  const int rows = mode == kInt8 ? k : k / 2;
  const int batch = kM1Loads * 32 / (slab / 16);
  const int unit = mode == kInt8 ? batch : (group == k ? 64 : group / 2);
  return rows_per_warp > 0 && unit % batch == 0 && rows_per_warp % unit == 0 &&
         rows_per_block == warps * rows_per_warp && (long)(cluster - 1) * rows_per_block < rows &&
         rows <= (long)cluster * rows_per_block;
}

// Whether the launch shape is one _gemv_plan (ops/quant.py) can give; the
// operands' alignment, N % 16 and K % 8 are checked by the caller.
bool m1_takes(int mode, const M1Args& a, int cluster, int warps) {
  if ((a.slab != 64 && a.slab != 128) || (cluster != 2 && cluster != 4 && cluster != 8) ||
      warps < 1 || warps > kM1MaxWarps || (mode == kInt4ScaleOnWeights && a.slab != 128))
    return false;
  return split_takes(mode, a.K, a.group, a.slab, a.rows_per_block, a.rows_per_warp, cluster,
                     warps) &&
         m1_smem_bytes(mode, a, warps) <= kM1SmemBytes;
}

template <int MODE>
int launch_gemv_m1(const M1Args& a, int cluster, int warps, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + a.slab - 1) / a.slab) * cluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = m1_smem_bytes(MODE, a, warps);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_m1_kernel<MODE>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMV: 2 <= M <= 8, bf16 x, modes 0-2, on the tensor cores, split over a
// thread-block cluster
// ---------------------------------------------------------------------------

// These match GEMV_M8_BATCH_BYTES and GEMV_M8_SMEM_BYTES in ops/quant.py.
constexpr int kM8BatchBytes = 128;       // weight bytes a lane loads a batch
constexpr int kM8SmemBytes = 96 * 1024;  // x, the scales and the sums; two blocks an SM fit

struct M8Args {
  const __nv_bfloat16* x;  // [M, K], rows ldx apart; base and rows 16-byte aligned
  int64_t ldx;
  const uint8_t* w;        // int8 [K, N] or packed int4 [K/2, N], 16-byte aligned
  const float* scale;      // [N] (mode 0) or [K/group, N], 16-byte aligned
  __nv_bfloat16* out;      // [M, N]
  int M, N, K, group;
  int slab;                // stored bytes of a row a cluster owns: 64 or 128
  int rows_per_block, rows_per_warp;  // stored rows
};

// Words (bf16 pairs) from one row of the staged x to the next: the block's
// K rows, padded so that the 8 rows' B fragments fall in 32 distinct banks.
__device__ __host__ __forceinline__ int m8_x_stride(int mode, int rows_per_block) {
  const int words = rows_per_block * (mode == kInt8 ? 1 : 2) / 2;
  return words + (36 - words % 32) % 32;
}

// the kernel's shared memory: MT rows of x, the slab's scales (mode 0: one
// row; modes 1, 2: the block's groups) and the sums of the columns the block
// finishes, for MT rows, from every warp of the cluster
__host__ __forceinline__ size_t m8_smem_bytes(int mode, const M8Args& a, int warps, int mt) {
  const int groups = mode == kInt8 || a.group == a.K ? 1 : 2 * a.rows_per_block / a.group;
  return 4 * ((size_t)mt * m8_x_stride(mode, a.rows_per_block) + (size_t)groups * a.slab +
              (size_t)warps * mt * a.slab);
}

// W bytes of a weight row that are read once: past L1, not kept there
template <int W>
__device__ __forceinline__ void m8_ld(const uint8_t* p, uint32_t (&v)[W / 4]) {
  if constexpr (W == 16) {
    const uint4 u = ld_stream(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v[0]), "=r"(v[1])
                 : "l"(p));
  }
}

// One batch of a lane's loads: its W columns of the stored rows of each
// 16-K-row tile from rb on that an m16n8k16 A fragment takes from lane
// t = lane % 4: int8 rows 2t, 2t + 1, 2t + 8, 2t + 9; packed int4 rows t
// and t + 4 (K rows 2t, 2t + 1 and 2t + 8, 2t + 9). Zero past the warp's
// last row or past N.
template <int MODE, int W>
__device__ __forceinline__ void m8_load(const M8Args& a, bool live, int col, int rb, int end,
                                        int t, uint32_t (&buf)[kM8BatchBytes / W][W / 4]) {
  constexpr int kTileLoads = MODE == kInt8 ? 4 : 2, kTileRows = MODE == kInt8 ? 16 : 8;
#pragma unroll
  for (int u = 0; u < kM8BatchBytes / W; ++u) {
    const int j = u % kTileLoads;
    const int r = rb + (u / kTileLoads) * kTileRows +
                  (MODE == kInt8 ? 2 * t + (j & 1) + 8 * (j >> 1) : t + 4 * j);
    if (live && r < end) {
      m8_ld<W>(a.w + (int64_t)r * a.N + col, buf[u]);
    } else {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) buf[u][i] = 0u;
    }
  }
}

// A lane's sums: the C fragments of its W / 2 column pairs (c0, c1: the
// pair's first column at x rows 2t, 2t + 1; c2, c3: its second column) and,
// in mode 1, the current scale group's; its batches so far and its columns
// of the staged scales.
template <int MODE, int W>
struct M8Sums {
  float acc[W / 2][4] = {};
  float part[MODE == kInt4 ? W / 2 : 1][4] = {};
  int group_batch = 0;
  const float* group_scale = nullptr;  // the lane's W columns of the group's staged scales
  int scale_stride = 0;                // floats from one group's staged scales to the next
};

// Consume one batch: each tile's weights dequantized to bf16 pairs along K
// (the A fragments: int8 by the exact bit trick of the wgmma GEMM, int4 by
// gemv_m1_kernel<2>'s; mode 2 then q * bf16(scale), rounded once by HMUL2)
// times x's B fragment (b0, b1: x row g = lane / 4 at the tile's K rows
// 2t, 2t + 1 and 2t + 8, 2t + 9; zero past MT), one m16n8k16 a column pair.
// In mode 1, at the end of a scale group or of the warp's rows (last), the
// group's sums times its scales into acc.
template <int MODE, int MT, int W>
__device__ __forceinline__ void m8_consume(const uint32_t* xs, int x_stride, int tau0, int g,
                                           int t, const uint32_t (&buf)[kM8BatchBytes / W][W / 4],
                                           bool last, int group_batches, M8Sums<MODE, W>& s) {
  constexpr int kTileLoads = MODE == kInt8 ? 4 : 2;
  constexpr int kTiles = kM8BatchBytes / W / kTileLoads;
  uint32_t sc[MODE == kInt4ScaleOnWeights ? W : 1];  // mode 2: the lane's bf16 scales, as pairs
  if constexpr (MODE == kInt4ScaleOnWeights) {
    const uint4* sp = reinterpret_cast<const uint4*>(s.group_scale);
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 v = sp[q];
      sc[4 * q] = v.x, sc[4 * q + 1] = v.y, sc[4 * q + 2] = v.z, sc[4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    uint32_t b[2] = {0u, 0u};
    if (g < MT) {
      const uint32_t* xr = xs + g * x_stride + 8 * (tau0 + i) + t;
      b[0] = xr[0];
      b[1] = xr[4];
    }
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      // columns 4q .. 4q + 3: pairs (4q, 4q + 1) and (4q + 2, 4q + 3)
      if constexpr (MODE == kInt8) {
        // rows 2t, 2t + 1, 2t + 8, 2t + 9
        const uint32_t l0 = buf[kTileLoads * i][q], l1 = buf[kTileLoads * i + 1][q];
        const uint32_t l2 = buf[kTileLoads * i + 2][q], l3 = buf[kTileLoads * i + 3][q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // byte c of two rows into bytes 0 and 2: column c's pair along K
          const int sel0 = 2 * h | (4 + 2 * h) << 8, sel1 = (2 * h + 1) | (5 + 2 * h) << 8;
          const uint32_t a[4] = {int8x2_to_bf16(__byte_perm(l0, l1, sel0)),
                                 int8x2_to_bf16(__byte_perm(l0, l1, sel1)),
                                 int8x2_to_bf16(__byte_perm(l2, l3, sel0)),
                                 int8x2_to_bf16(__byte_perm(l2, l3, sel1))};
          mma_16816(s.acc[2 * q + h], a, b);
        }
      } else {
        uint32_t p0[4], p1[4];  // (q of row 2r, q of row 2r + 1) of columns 4q .. 4q + 3
        int4_pairs(buf[kTileLoads * i][q], p0);
        int4_pairs(buf[kTileLoads * i + 1][q], p1);
        if constexpr (MODE == kInt4ScaleOnWeights) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p0[c] = bf16x2_mul(p0[c], sc[4 * q + c]);
            p1[c] = bf16x2_mul(p1[c], sc[4 * q + c]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {p0[2 * h], p0[2 * h + 1], p1[2 * h], p1[2 * h + 1]};
          if constexpr (MODE == kInt4)
            mma_16816(s.part[2 * q + h], a, b);
          else
            mma_16816(s.acc[2 * q + h], a, b);
        }
      }
    }
  }
  if constexpr (MODE == kInt4) {
    if (++s.group_batch == group_batches || last) {
#pragma unroll
      for (int p = 0; p < W / 2; ++p) {
        const float2 sv = *reinterpret_cast<const float2*>(s.group_scale + 2 * p);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.acc[p][e] = fmaf(s.part[p][e], e < 2 ? sv.x : sv.y, s.acc[p][e]);
          s.part[p][e] = 0.f;
        }
      }
      s.group_batch = 0;
      s.group_scale += s.scale_stride;
    }
  } else if constexpr (MODE == kInt4ScaleOnWeights) {
    if (++s.group_batch == group_batches) {
      s.group_batch = 0;
      s.group_scale += s.scale_stride;
    }
  }
}

// 2 <= M <= 8 rows of bf16 x, padded with zeros to MT (2, 4 or 8) in shared
// memory, times the weights, every weight byte streamed once for all rows.
// As gemv_m1_kernel: a cluster owns a slab of `slab` = 8 W bytes of every
// stored row, its blocks split the rows in rank order and a block's warps
// split the block's rows, in whole batches and (modes 1, 2) whole scale
// groups; the sums meet in distributed shared memory in rank order. Unlike
// it, every mode multiplies on the tensor cores: lane g = lane / 4 owns
// bytes W g .. W g + W - 1 of the slab (16-byte loads at W = 16, 8-byte at
// W = 8, 128 bytes a lane in flight a batch while the last is consumed),
// lane t = lane % 4 loads the tile's rows its A fragments hold, and each
// m16n8k16 takes a column pair of each lane group as A's 16 rows and the
// MT rows of x as M of B's 8 columns. So its instructions a weight do not
// grow with M: per packed byte, int8 ~2 (a byte permute and the two-LOP3,
// one-HSUB2 reading a pair of values), int4 ~3.25 (int4_pairs), mode 2 one
// HMUL2 a pair more, and an HMMA per 4 (int4) or 8 (int8) bytes; on the
// CUDA cores mode 0 would need ~3 + M. The products are exact in fp32;
// mode 1 keeps a scale group's in its own C fragments and scales them at the
// group's end. x is staged once a block as bf16 (row stride m8_x_stride), the
// scales as gemv_m1_kernel stages them.
template <int MODE, int MT, int W>
__global__ void __launch_bounds__(kM1MaxWarps * 32) gemv_m8_kernel(M8Args a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float m8_smem[];
  constexpr int kBatchRows = 4 * kM8BatchBytes / W;  // stored rows: 2 or 4 tiles (int8), 4 or 8 (int4)
  constexpr int kTileRows = MODE == kInt8 ? 16 : 8;
  constexpr int kXPerRow = MODE == kInt8 ? 1 : 2;
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warps = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows = MODE == kInt8 ? a.K : a.K / 2;
  const int slab0 = (blockIdx.x / n_ranks) * a.slab;
  const int col = slab0 + W * g;
  const bool live = col < a.N;
  const int b0 = rank * a.rows_per_block;
  const int w0 = b0 + warp * a.rows_per_warp;
  const int w1 = min(w0 + a.rows_per_warp, rows);  // <= w0: a warp without rows

  const int xn = kXPerRow * a.rows_per_block;  // K rows of x the block stages
  const int x_stride = m8_x_stride(MODE, a.rows_per_block);
  const int groups = m1_groups(MODE, a);
  const int g0 = MODE == kInt8 ? 0 : 2 * b0 / a.group;
  const int scale_rows = MODE == kInt8 ? 1 : a.K / a.group;
  const int share = a.slab / n_ranks;  // columns each rank finishes
  uint32_t* xs = reinterpret_cast<uint32_t*>(m8_smem);  // [MT][x_stride] bf16 pairs, zero past M, K
  float* ss = m8_smem + MT * x_stride;                  // [groups][slab]: the scales, zero past N
  float* sums = ss + groups * a.slab;                   // [ranks][warps][MT][share]
  float4* ss4 = reinterpret_cast<float4*>(ss);

  // x of the block's rows (16-byte runs, MT rows) and the slab's scales,
  // their first loads sent ahead of the weights'
  const int xk0 = kXPerRow * b0;
  const int runs = xn / 8, x_runs = MT * runs, n_scales = groups * (a.slab / 4);
  const auto x_load = [&](int i) {
    const int m = i / runs, k = xk0 + 8 * (i % runs);
    return i < x_runs && m < a.M && k < a.K
               ? __ldg(reinterpret_cast<const uint4*>(a.x + m * a.ldx + k))
               : make_uint4(0u, 0u, 0u, 0u);
  };
  const auto x_store = [&](int i, uint4 v) {
    *reinterpret_cast<uint4*>(xs + (i / runs) * x_stride + 4 * (i % runs)) = v;
  };
  uint4 xv[kM1Stage];
  float4 sv[kM1Stage];
#pragma unroll
  for (int q = 0; q < kM1Stage; ++q) {
    xv[q] = x_load(tid + q * blockDim.x);
    sv[q] = m1_scale_load(a, scale_rows, g0, slab0, n_scales, tid + q * blockDim.x);
  }
  uint32_t cur[kM8BatchBytes / W][W / 4];
  m8_load<MODE, W>(a, live, col, w0, w1, t, cur);
#pragma unroll
  for (int q = 0; q < kM1Stage; ++q) {
    const int i = tid + q * blockDim.x;
    if (i < x_runs) x_store(i, xv[q]);
    if (i < n_scales) ss4[i] = m1_scale_staged<MODE>(sv[q]);
  }
  for (int i = tid + kM1Stage * blockDim.x; i < x_runs; i += blockDim.x) x_store(i, x_load(i));
  for (int i = tid + kM1Stage * blockDim.x; i < n_scales; i += blockDim.x)
    ss4[i] = m1_scale_staged<MODE>(m1_scale_load(a, scale_rows, g0, slab0, n_scales, i));
  __syncthreads();

  M8Sums<MODE, W> mine;
  // int4: batches a scale group takes (never, where one group spans K), and
  // the warp's first group's row of the staged scales
  const int group_batches = a.group == a.K ? rows : a.group / 2 / kBatchRows;
  if constexpr (MODE != kInt8) {
    mine.group_scale = ss + (2 * w0 / a.group - g0) * a.slab + W * g;
    mine.scale_stride = a.slab;
  }
  for (int rb = w0; rb < w1; rb += kBatchRows) {
    uint32_t nxt[kM8BatchBytes / W][W / 4];  // the next batch goes out before this one is consumed
    m8_load<MODE, W>(a, live, col, rb + kBatchRows, w1, t, nxt);
    m8_consume<MODE, MT, W>(xs, x_stride, (rb - b0) / kTileRows, g, t, cur,
                            rb + kBatchRows >= w1, group_batches, mine);
#pragma unroll
    for (int u = 0; u < kM8BatchBytes / W; ++u)
#pragma unroll
      for (int i = 0; i < W / 4; ++i) cur[u][i] = nxt[u][i];
  }

  // each lane's columns W g + 2p, + 1 at x rows 2t, 2t + 1 (rows past MT
  // hold zeros) to the rank that finishes them, four columns a store,
  // through distributed shared memory; one cluster barrier orders them
  if (2 * t < MT) {
#pragma unroll
    for (int p = 0; p < W / 2; p += 2) {
      const int c = W * g + 2 * p, owner = c / share;
      float* dst = cluster.map_shared_rank(sums, owner) + c % share;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(dst + ((rank * warps + warp) * MT + 2 * t + r) * share) =
            make_float4(mine.acc[p][r], mine.acc[p][2 + r], mine.acc[p + 1][r],
                        mine.acc[p + 1][2 + r]);
    }
  }
  cluster.sync();
  // every warp of the cluster, rank by rank, in order
  for (int i = tid; i < a.M * share; i += blockDim.x) {
    const int m = i / share, c = i % share;
    float v = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_ranks * warps; ++j) v += sums[(j * MT + m) * share + c];
    const int n = slab0 + rank * share + c;
    if (n < a.N) {
      if constexpr (MODE == kInt8) v *= ss[rank * share + c];
      a.out[(int64_t)m * a.N + n] = __float2bfloat16(v);
    }
  }
}

// Whether the launch shape is one _gemv_plan gives at 2 <= M <= 8.
bool m8_takes(int mode, const M8Args& a, int cluster, int warps) {
  if ((a.slab != 64 && a.slab != 128) || (cluster != 2 && cluster != 4 && cluster != 8) ||
      warps < 1 || warps > kM1MaxWarps)
    return false;
  const int mt = a.M <= 2 ? 2 : a.M <= 4 ? 4 : 8;
  return split_takes(mode, a.K, a.group, a.slab, a.rows_per_block, a.rows_per_warp, cluster,
                     warps) &&
         m8_smem_bytes(mode, a, warps, mt) <= kM8SmemBytes;
}

template <int MODE, int MT, int W>
int launch_gemv_m8(const M8Args& a, int cluster, int warps, cudaStream_t st) {
  const size_t smem = m8_smem_bytes(MODE, a, warps, MT);
  if (smem > 48 * 1024) {
    // above the default, as dynamic shared memory the function opts into
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_m8_kernel<MODE, MT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kM8SmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + a.slab - 1) / a.slab) * cluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_m8_kernel<MODE, MT, W>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE, int MT>
int launch_gemv_m8_slab(const M8Args& a, int cluster, int warps, cudaStream_t st) {
  return a.slab == 128 ? launch_gemv_m8<MODE, MT, 16>(a, cluster, warps, st)
                       : launch_gemv_m8<MODE, MT, 8>(a, cluster, warps, st);
}

template <int MODE>
int launch_gemv_m8_rows(const M8Args& a, int cluster, int warps, cudaStream_t st) {
  if (a.M <= 2) return launch_gemv_m8_slab<MODE, 2>(a, cluster, warps, st);
  if (a.M <= 4) return launch_gemv_m8_slab<MODE, 4>(a, cluster, warps, st);
  return launch_gemv_m8_slab<MODE, 8>(a, cluster, warps, st);
}


template <typename T, int MODE>
int launch(const Args& a, cudaStream_t st) {
  if (a.M <= 8) {
    const dim3 grid((a.N + kGvBlockN - 1) / kGvBlockN);
    if (a.M == 1)
      gemv_kernel<T, MODE, 1><<<grid, kGvThreads, 0, st>>>(a);
    else if (a.M == 2)
      gemv_kernel<T, MODE, 2><<<grid, kGvThreads, 0, st>>>(a);
    else if (a.M <= 4)
      gemv_kernel<T, MODE, 4><<<grid, kGvThreads, 0, st>>>(a);
    else
      gemv_kernel<T, MODE, 8><<<grid, kGvThreads, 0, st>>>(a);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (wgmma_takes(MODE, a))
      return pick_bn(a.M, a.N) == 64 ? launch_wgmma<MODE, 64>(a, st)
                                     : launch_wgmma<MODE, 128>(a, st);
    const dim3 grid((a.N + kTcBN - 1) / kTcBN, (a.M + kTcBM - 1) / kTcBM);
    gemm_tc_kernel<MODE><<<grid, kTcThreads, 0, st>>>(a);
  } else {
    const dim3 grid((a.N + kGmBN - 1) / kGmBN, (a.M + kGmBM - 1) / kGmBM);
    gemm_kernel<T, MODE><<<grid, kGmThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const Args& a, cudaStream_t st) {
  if (mode == kInt8) return launch<T, kInt8>(a, st);
  if (mode == kInt4) return launch<T, kInt4>(a, st);
  return launch<T, kInt4ScaleOnWeights>(a, st);
}

}  // namespace

extern "C" {

// mode: 0 = int8 (K3), 1 = int4 with partial-sum scaling (K4), 2 = int4 with
// the scale on the weights (K4b/K4c). dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success).
int cambrian_quant_matmul(int mode, int dtype, const void* x, int64_t ldx, const void* w,
                          const float* scale, void* out, int m, int n, int k, int group,
                          void* stream) {
  if (m < 1 || n < 1 || k < 1 || ldx < k || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (mode != kInt8 && (k % 2 != 0 || group < 1 || k % group != 0 ||
                        (group != k && group % kGmBK != 0)))
    return (int)cudaErrorInvalidValue;
  const int vec = (n % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 8 == 0);
  const int xvec = (k % 8 == 0) && (ldx % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const Args a{x, ldx, static_cast<const int8_t*>(w), scale, out, m, n, k, group, vec, xvec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(mode, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(mode, a, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 M = 1 GEMV of modes 0-2 (gemv_m1_kernel) under the launch
// shape of a GemvPlan (ops/quant.py): x bf16 [K], out bf16 [N]. Returns
// cudaErrorInvalidValue, launching nothing, for operands or a shape the
// kernel does not take.
int cambrian_quant_gemv_m1(int mode, const void* x, const void* w, const float* scale, void* out,
                           int n, int k, int group, int slab, int cluster, int warps,
                           int rows_per_block, int rows_per_warp, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (mode < kInt8 || mode > kInt4ScaleOnWeights || n < 16 || n % 16 != 0 || k < 8 ||
      k % 8 != 0 || misaligned(x) || misaligned(w) || misaligned(scale))
    return (int)cudaErrorInvalidValue;
  if (mode != kInt8 && (group < 1 || k % group != 0 ||
                        (group % 128 != 0 && !(group == k && k % 128 == 0))))
    return (int)cudaErrorInvalidValue;
  const M1Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w), scale,
                 static_cast<__nv_bfloat16*>(out), n, k, mode == kInt8 ? 1 : group, slab,
                 rows_per_block, rows_per_warp};
  if (!m1_takes(mode, a, cluster, warps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kInt8) return launch_gemv_m1<kInt8>(a, cluster, warps, st);
  if (mode == kInt4) return launch_gemv_m1<kInt4>(a, cluster, warps, st);
  return launch_gemv_m1<kInt4ScaleOnWeights>(a, cluster, warps, st);
}

// The bf16 GEMV of modes 0-2 at 2 <= M <= 8 (gemv_m8_kernel) under the
// launch shape of a GemvPlan: x bf16 [M, K] with rows ldx elements apart
// (ldx % 8 == 0), out bf16 [M, N]. Returns cudaErrorInvalidValue, launching
// nothing, for operands or a shape the kernel does not take.
int cambrian_quant_gemv_m8(int mode, const void* x, int64_t ldx, const void* w,
                           const float* scale, void* out, int m, int n, int k, int group,
                           int slab, int cluster, int warps, int rows_per_block,
                           int rows_per_warp, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (mode < kInt8 || mode > kInt4ScaleOnWeights || m < 2 || m > 8 || n < 16 || n % 16 != 0 ||
      k < 8 || k % 8 != 0 || ldx < k || ldx % 8 != 0 || misaligned(x) || misaligned(w) ||
      misaligned(scale))
    return (int)cudaErrorInvalidValue;
  if (mode != kInt8 && (group < 1 || k % group != 0 ||
                        (group % 128 != 0 && !(group == k && k % 128 == 0))))
    return (int)cudaErrorInvalidValue;
  const M8Args a{static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const uint8_t*>(w),
                 scale, static_cast<__nv_bfloat16*>(out), m, n, k, mode == kInt8 ? 1 : group,
                 slab, rows_per_block, rows_per_warp};
  if (!m8_takes(mode, a, cluster, warps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kInt8) return launch_gemv_m8_rows<kInt8>(a, cluster, warps, st);
  if (mode == kInt4) return launch_gemv_m8_rows<kInt4>(a, cluster, warps, st);
  return launch_gemv_m8_rows<kInt4ScaleOnWeights>(a, cluster, warps, st);
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
