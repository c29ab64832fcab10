// Fused two-layer GELU MLP for Hopper (sm_90a), with a plain C interface that
// cambrian_tpu_torch/ops/fused_mlp.py loads through ctypes. Kernel K8 of the
// port: replaces the TPU kernel _fused_mlp_kernel of
// cambrian_tpu/ops/fused_mlp.py (reached from fused_mlp).
//
//   h   = gelu(x @ W1 + b1)   x @ W1 summed in fp32, b1 added in fp32, GELU in
//                             fp32 with the Abramowitz-Stegun erf of the TPU
//                             kernel, then h rounded to x's dtype
//   out = h @ W2 + b2         summed in fp32, b2 added in fp32, cast once
//
// x [M, C] (row stride ldx), and the weights in nn.Linear's layout: W1^T
// [H, C] and W2^T [C2, H], contiguous, in x's dtype; b1 [H] and b2 [C2] fp32
// or absent.
//
// What bounds it on the card: at the shapes it is built for (ConvNeXt's
// C -> 4C -> C pairs, M in the thousands; the SVA Mlps at 576 rows) the
// operations, on the tensor cores: 2 M H (C + C2), 0.156 ms at the bf16 peak
// for every ConvNeXt stage.
//
// Why the hidden leaves the SM. The TPU kernel keeps a [block_m, C2] fp32
// accumulator in VMEM while it walks the hidden axis. Nothing on a Hopper SM
// holds that: a 128-row hidden slab is 1.5 MB of bf16 at H = 6144, the
// 128-row fp32 accumulator 768 KB at C2 = 1536, against 227 KB of shared
// memory and 256 KB of registers. Recomputing the slab in every block of an
// output row (the first port) did the first product ceil(C2 / 256) times.
// The store that does hold the hidden is the 50 MB L2, so bf16 x takes two
// GEMMs that meet there:
//   up:   H_chunk = bf16(gelu(x_chunk @ W1 + b1))   (mlp_up_kernel)
//   down: out_chunk = bf16(H_chunk @ W2 + b2)       (mlp_down_kernel)
// The wrapper (ops/fused_mlp.py's _plan, then cambrian_fused_mlp_wgmma
// here) walks M in chunks whose bf16 hidden fits one fixed budget
// (HIDDEN_CHUNK_BYTES) and, for each chunk, launches up then down on the
// stream, into one scratch it allocated and reuses, so that the hidden
// written by up is still in L2 when down reads it. The
// round trip is cheap against the products (the whole stage-3 hidden,
// 50 MB, would take ~0.03 ms even through HBM); the chunk matters where C
// is small (stage 1's 201 MB hidden, ~0.12 ms through HBM). The roundings
// are the TPU kernel's: bias and GELU on the fp32 accumulator, h to bf16.
//
// Each GEMM is the producer / consumer loop of quant_matmul.cu's
// gemm_wgmma_kernel without its dequantization: both operands K-major
// (x or H as A, rows of W1^T or W2^T as B), so wgmma reads both from
// shared memory without the transpose bit. A block owns a 128 x BN output
// tile (BN = 64, 128, 192 or 256; the wrapper's _plan picks it from the
// waves of tiles on the card's SMs) and walks K in 64-column slabs through
// a ring of 3 or 4 stages: one producer warp loads each stage by TMA (128-byte
// swizzle, completing on the stage's mbarrier), two consumer warpgroups
// (64 rows each) issue the slab's four m64nBNk16 wgmma, keep one group in
// flight, and release a stage once its products have completed. The
// epilogue adds the bias (and GELU) to the fp32 accumulator and stores bf16
// pairs. Blocks run M-tile first, so the blocks that share a weight tile
// run together. Not persistent: a block's epilogue leaves its SM's tensor
// cores idle, which costs the up GEMM, whose epilogue evaluates GELU for
// every output, about half again the down GEMM's time for the same products.
//
// TMA needs 16-byte-aligned bases and row strides: C, H and C2 multiples of
// 8, ldx % 8 == 0, and 16-byte-aligned x, W1^T and W2^T. bf16 operands
// that miss this take fused_mlp_tc_kernel, the first port's kernel: a block
// owns a 64 x 256 output tile in registers and walks the hidden axis in
// 64-wide chunks, recomputing each chunk's [64, 64] slab from x and W1 on
// mma.sync m16n8k16 and multiplying it into the tile (no hidden in device
// memory, the first product ceil(C2 / 256) times). fp32 x takes the SIMT
// version of that kernel on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Args {
  const void* x;     // [M, C], row stride ldx, unit stride along C
  const void* w1t;   // [H, C] contiguous
  const float* b1;   // [H] or null
  const void* w2t;   // [C2, H] contiguous
  const float* b2;   // [C2] or null
  void* out;         // [M, C2] contiguous
  int64_t ldx;
  int M, C, H, C2;
  int vec;           // 1: rows of x, W1^T and W2^T may be read as aligned runs of 8 bf16
};

// Abramowitz-Stegun 7.1.26, as cambrian_tpu/ops/fused_mlp.py:_erf, in few
// instructions: the up GEMM's epilogue evaluates it for every hidden
// element. The reciprocal and 2^x are the special-function unit's
// approximations (relative errors near 2^-22, far below the formula's
// 1.5e-7 and h's bf16 rounding); the sign is copied from x, so erf(0) comes
// out ~1e-9 and gelu(0) is still 0.
__device__ __forceinline__ float erf_as(float x) {
  const float p = 0.3275911f;
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f;
  const float ax = fabsf(x);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(p, ax, 1.0f)));
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float e = hopper::exp2_approx(ax * (ax * -1.4426950408889634f));  // exp(-x^2)
  return copysignf(fmaf(-poly, e, 1.0f), x);
}

__device__ __forceinline__ float gelu(float v) {
  const float half = 0.5f * v;
  return fmaf(half, erf_as(v * 0.7071067811865476f), half);
}

// ---------------------------------------------------------------------------
// bf16, operands TMA cannot address: mma.sync, the hidden recomputed per block
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 64;         // rows of x per block
constexpr int kBN = 256;        // output columns per block
constexpr int kBH = 64;         // hidden chunk
constexpr int kBK = 32;         // depth of a staged tile
constexpr int kLdK = kBK + 8;   // smem row of 40 bf16 (80 bytes): conflict-free fragments
constexpr int kLdH = kBH + 8;   // 72 bf16 (144 bytes)

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

// 8 bf16 of row r from column c on, of a row-major [rows, cols] matrix with
// row stride ld; zeros past the edges
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* base, int64_t ld, int r, int c,
                                       int rows, int cols, int vec) {
  if (r >= rows || c >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* p = base + (int64_t)r * ld + c;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));  // cols % 8 == 0
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = c + 2 * e < cols ? ps[2 * e] : 0u;
    const uint32_t hi = c + 2 * e + 1 < cols ? ps[2 * e + 1] : 0u;
    v[e] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// A fragments (16 x 16) of rows row0.. of a [*, ld] bf16 smem tile at column ks
template <int LD>
__device__ __forceinline__ void load_a(__nv_bfloat16 (*s)[LD], int row, int ks, int tq,
                                       uint32_t (&af)[4]) {
  af[0] = *reinterpret_cast<const uint32_t*>(&s[row][ks + 2 * tq]);
  af[1] = *reinterpret_cast<const uint32_t*>(&s[row + 8][ks + 2 * tq]);
  af[2] = *reinterpret_cast<const uint32_t*>(&s[row][ks + 2 * tq + 8]);
  af[3] = *reinterpret_cast<const uint32_t*>(&s[row + 8][ks + 2 * tq + 8]);
}

// B fragments (16 x 8) from an [n][k] smem tile
template <int LD>
__device__ __forceinline__ void load_b(__nv_bfloat16 (*s)[LD], int col, int ks, int tq,
                                       uint32_t (&bf)[2]) {
  bf[0] = *reinterpret_cast<const uint32_t*>(&s[col][ks + 2 * tq]);
  bf[1] = *reinterpret_cast<const uint32_t*>(&s[col][ks + 2 * tq + 8]);
}

__global__ void __launch_bounds__(kThreads) fused_mlp_tc_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 Xs[kBM][kLdK];   // x tile [m][k]
  __shared__ __align__(16) __nv_bfloat16 W1s[kBH][kLdK];  // W1^T tile [h][k]
  __shared__ __align__(16) __nv_bfloat16 Hs[kBM][kLdH];   // hidden slab [m][h]
  __shared__ __align__(16) __nv_bfloat16 W2s[kBN][kLdK];  // W2^T tile [n][h]
  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* W1 = static_cast<const __nv_bfloat16*>(a.w1t);
  const __nv_bfloat16* W2 = static_cast<const __nv_bfloat16*>(a.w2t);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column pair of this lane
  const int wm = (warp / 4) * 32;           // 2 warps along M, 32 rows each
  const int wn = (warp % 4) * 64;           // 4 along the output tile, 64 columns each
  const int wh = (warp % 4) * 16;           // 4 along the hidden chunk, 16 columns each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lr = tid >> 2, lc = (tid & 3) * 8;  // staging: 64 rows x 4 runs of 8

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int h0 = 0; h0 < a.H; h0 += kBH) {
    // hidden slab [64, 64] = x[m0.., :] @ W1[:, h0..]
    float hacc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < a.C; k0 += kBK) {
      *reinterpret_cast<uint4*>(&Xs[lr][lc]) = load8(X, a.ldx, m0 + lr, k0 + lc, a.M, a.C, a.vec);
      *reinterpret_cast<uint4*>(&W1s[lr][lc]) = load8(W1, a.C, h0 + lr, k0 + lc, a.H, a.C, a.vec);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t af[2][4], bf[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) load_a<kLdK>(Xs, wm + i * 16 + gq, ks, tq, af[i]);
#pragma unroll
        for (int j = 0; j < 2; ++j) load_b<kLdK>(W1s, wh + j * 8 + gq, ks, tq, bf[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_16816(hacc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
    // + b1 and GELU in fp32, rounded to bf16 (x's dtype) into shared memory;
    // hidden columns past H are 0 (zero weights and bias, gelu(0) = 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm + i * 16 + gq + 8 * hh, col = wh + j * 8 + 2 * tq;
          float v0 = hacc[i][j][2 * hh], v1 = hacc[i][j][2 * hh + 1];
          if (a.b1 != nullptr) {
            const int hg = h0 + col;
            v0 += hg < a.H ? __ldg(a.b1 + hg) : 0.f;
            v1 += hg + 1 < a.H ? __ldg(a.b1 + hg + 1) : 0.f;
          }
          *reinterpret_cast<uint32_t*>(&Hs[row][col]) = pack_bf16x2(gelu(v0), gelu(v1));
        }
    // out tile [64, 256] += hidden slab @ W2[h0.., n0..]
    for (int kk = 0; kk < kBH; kk += kBK) {
#pragma unroll
      for (int p = 0; p < kBN / 64; ++p) {
        const int r = p * 64 + lr;
        *reinterpret_cast<uint4*>(&W2s[r][lc]) =
            load8(W2, a.H, n0 + r, h0 + kk + lc, a.C2, a.H, a.vec);
      }
      __syncthreads();  // (the first pass also publishes Hs)
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t af[2][4], bf[8][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) load_a<kLdH>(Hs, wm + i * 16 + gq, kk + ks, tq, af[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) load_b<kLdK>(W2s, wn + j * 8 + gq, ks, tq, bf[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_16816(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + i * 16 + gq + 8 * hh;
        if (m >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * tq + e;
          if (n >= a.C2) continue;
          float v = acc[i][j][2 * hh + e];
          if (a.b2 != nullptr) v += __ldg(a.b2 + n);
          O[(int64_t)m * a.C2 + n] = __float2bfloat16(v);
        }
      }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSBM = 64;   // rows per block (16 thread rows x 4)
constexpr int kSBN = 64;   // output columns per block (16 thread columns x 4)
constexpr int kSBH = 32;   // hidden chunk (16 thread columns x 2)
constexpr int kSBK = 32;   // depth of a staged x / W1 tile

__global__ void __launch_bounds__(kThreads) fused_mlp_simt_kernel(Args a) {
  __shared__ float Xs[kSBK][kSBM + 4];   // x tile, [k][m]
  __shared__ float W1s[kSBK][kSBH];      // [k][h]
  __shared__ float Hs[kSBH][kSBM + 4];   // hidden slab, [h][m]
  __shared__ float W2s[kSBH][kSBN];      // [h][n]
  const float* X = static_cast<const float*>(a.x);
  const float* W1 = static_cast<const float*>(a.w1t);
  const float* W2 = static_cast<const float*>(a.w2t);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < a.H; h0 += kSBH) {
    float hacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[i][0] = hacc[i][1] = 0.f;
    for (int k0 = 0; k0 < a.C; k0 += kSBK) {
#pragma unroll
      for (int i = 0; i < kSBM * kSBK / kThreads; ++i) {
        const int idx = tid + i * kThreads, mm = idx / kSBK, kk = idx % kSBK;
        const int m = m0 + mm, k = k0 + kk;
        Xs[kk][mm] = (m < a.M && k < a.C) ? X[(int64_t)m * a.ldx + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSBH * kSBK / kThreads; ++i) {
        const int idx = tid + i * kThreads, hh = idx / kSBK, kk = idx % kSBK;
        const int h = h0 + hh, k = k0 + kk;
        W1s[kk][hh] = (h < a.H && k < a.C) ? W1[(int64_t)h * a.C + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSBK; ++kk) {
        float av[4], bv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Xs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = W1s[kk][tx * 2 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) hacc[i][j] = fmaf(av[i], bv[j], hacc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int hg = h0 + tx * 2 + j;
      const float bj = (a.b1 != nullptr && hg < a.H) ? __ldg(a.b1 + hg) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) Hs[tx * 2 + j][ty * 4 + i] = gelu(hacc[i][j] + bj);
    }
#pragma unroll
    for (int i = 0; i < kSBH * kSBN / kThreads; ++i) {
      const int idx = tid + i * kThreads, nn = idx / kSBH, hh = idx % kSBH;
      const int n = n0 + nn, h = h0 + hh;
      W2s[hh][nn] = (n < a.C2 && h < a.H) ? W2[(int64_t)n * a.H + h] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int hh = 0; hh < kSBH; ++hh) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Hs[hh][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = W2s[hh][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* O = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.C2) continue;
      O[(int64_t)m * a.C2 + n] = acc[i][j] + (a.b2 != nullptr ? __ldg(a.b2 + n) : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, TMA-addressable operands: two wgmma GEMMs meeting in L2
// ---------------------------------------------------------------------------

constexpr int kGBM = 128;                     // rows of A per block, 64 per consumer warpgroup
constexpr int kGBK = 64;                      // K columns a stage: one 128-byte swizzled row
constexpr int kGConsumers = 256;              // two warpgroups
constexpr int kGThreads = kGConsumers + 32;   // and a producer warp

// Tiles up to 128 columns wide fit two blocks an SM (shared memory under
// 113 KB, registers under 112 a thread), so one block's epilogue overlaps
// the other's products; wider tiles take the SM alone, with 4 stages.
template <int BN>
struct GemmShape {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kBlocksPerSm = BN <= 128 ? 2 : 1;
};

template <int BN>
struct GemmSmem {
  static constexpr int kStages = GemmShape<BN>::kStages;
  __nv_bfloat16 a[kStages][kGBM * kGBK];  // x or H rows, 128-byte swizzle (TMA)
  __nv_bfloat16 b[kStages][BN * kGBK];    // rows of W1^T or W2^T, the same
  float bias[BN];                         // the tile's columns of the bias, 0 past N or absent
  uint64_t full[kStages];                 // the stage's TMA loads have landed
  uint64_t empty[kStages];                // its products have completed (every consumer warp)
};

template <int BN>
constexpr size_t gemm_smem_bytes() {
  return sizeof(GemmSmem<BN>) + 1024;  // room to align the base to the 128-byte swizzle's 1024
}

// out[M, N] (row stride ldo) = epilogue(A[M, K] @ B[N, K]^T + bias)
struct GemmArgs {
  const float* bias;   // [N] or null
  __nv_bfloat16* out;
  int64_t ldo;
  int M, N, K;
};

template <int BN>
__device__ __forceinline__ void wgmma_slab(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  using namespace hopper;
  if constexpr (BN == 64) wgmma_ss_n64(d, desc_a, desc_b, 1);
  else if constexpr (BN == 128) wgmma_ss_n128(d, desc_a, desc_b, 1);
  else if constexpr (BN == 192) wgmma_ss_n192(d, desc_a, desc_b, 1);
  else wgmma_ss_n256(d, desc_a, desc_b, 1);
}

template <bool GELU, int BN>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                          const GemmArgs& g) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<BN>& s = *reinterpret_cast<GemmSmem<BN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kGBM, n0 = blockIdx.y * BN;
  const int tiles = (g.K + kGBK - 1) / kGBK;
  constexpr int kGStages = GemmShape<BN>::kStages;

  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kGConsumers / 32);
    }
    mbar_init_fence();
  }
  for (int i = tid; i < BN; i += kGThreads)
    s.bias[i] = g.bias != nullptr && n0 + i < g.N ? __ldg(g.bias + n0 + i) : 0.f;
  __syncthreads();

  if (warp == kGConsumers / 32) {
    // producer: the A and B slabs of each K step through the ring; columns
    // past K and rows past M or N arrive as zeros
    if (lane == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int stage = t % kGStages, k0 = t * kGBK;
        mbar_wait(&s.empty[stage], ((t / kGStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[stage], (kGBM + BN) * kGBK * 2);
        tma_load_2d(s.a[stage], tm_a, &s.full[stage], k0, m0);
        tma_load_2d(s.b[stage], tm_b, &s.full[stage], k0, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kGStages;
    mbar_wait(&s.full[stage], (t / kGStages) & 1);
    const __nv_bfloat16* at = s.a[stage] + wg * 64 * kGBK;
    const __nv_bfloat16* bt = s.b[stage];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGBK / 16; ++kk)
      wgmma_slab<BN>(acc, desc_k_major<64>(at, kk), desc_k_major<64>(bt, kk));
    wgmma_commit();
    fence_regs(acc);
    // the previous slab's products have completed: release its stage, one
    // arrival a warp
    wgmma_wait<1>();
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[(t - 1) % kGStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: + bias (fp32) and GELU (up) on every accumulator, with no
  // branch, so that the compiler interleaves the independent GELU chains;
  // then one rounding to bf16 and the stores inside [M, N] (N % 8 == 0, so
  // a column pair is in or out whole)
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(&s.bias[8 * j + 2 * (lane % 4)]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * j + 2 * r] += b.x;
      acc[4 * j + 2 * r + 1] += b.y;
      if constexpr (GELU) {
        acc[4 * j + 2 * r] = gelu(acc[4 * j + 2 * r]);
        acc[4 * j + 2 * r + 1] = gelu(acc[4 * j + 2 * r + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    if (col >= g.N) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < g.M)
        *reinterpret_cast<__nv_bfloat162*>(g.out + (int64_t)row * g.ldo + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// H_chunk = bf16(gelu(x_chunk @ W1 + b1)): A = x rows, B = W1^T rows
template <int BN>
__global__ void __launch_bounds__(kGThreads, GemmShape<BN>::kBlocksPerSm) mlp_up_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
    GemmArgs g) {
  gemm_body<true, BN>(&tm_x, &tm_w1, g);
}

// out_chunk = bf16(H_chunk @ W2 + b2): A = hidden rows, B = W2^T rows
template <int BN>
__global__ void __launch_bounds__(kGThreads, GemmShape<BN>::kBlocksPerSm) mlp_down_kernel(
    const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w2,
    GemmArgs g) {
  gemm_body<false, BN>(&tm_h, &tm_w2, g);
}

// A tensor map over bf16 [rows, cols] (row stride ld elements) in boxes of
// 64 columns x box_rows rows, 128-byte swizzle
bool slab_map(CUtensorMap* map, const void* base, int cols, int rows, int64_t ld, int box_rows) {
  return hopper_host::tile_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, cols, rows,
                                  (uint64_t)ld * 2, kGBK, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool UP, int BN>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                cudaStream_t st) {
  const size_t smem = gemm_smem_bytes<BN>();
  const dim3 grid((g.M + kGBM - 1) / kGBM, (g.N + BN - 1) / BN);
  if constexpr (UP) {
    cudaError_t err = cudaFuncSetAttribute(mlp_up_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_up_kernel<BN><<<grid, kGThreads, smem, st>>>(ta, tb, g);
  } else {
    cudaError_t err = cudaFuncSetAttribute(mlp_down_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_down_kernel<BN><<<grid, kGThreads, smem, st>>>(ta, tb, g);
  }
  return (int)cudaGetLastError();
}

template <bool UP>
int launch_gemm_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                   cudaStream_t st) {
  switch (bn) {
    case 64: return launch_gemm<UP, 64>(ta, tb, g, st);
    case 128: return launch_gemm<UP, 128>(ta, tb, g, st);
    case 192: return launch_gemm<UP, 192>(ta, tb, g, st);
    case 256: return launch_gemm<UP, 256>(ta, tb, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The mma.sync (dtype 1 = bfloat16) and SIMT (dtype 0 = float32) kernels, x,
// the weights and out of that dtype. b1 and b2 may be null. Returns a
// cudaError_t (0 on success).
int cambrian_fused_mlp(int dtype, const void* x, int64_t ldx, const void* w1t, const float* b1,
                       const void* w2t, const float* b2, void* out, int m, int c, int h, int c2,
                       void* stream) {
  if (m < 1 || c < 1 || h < 1 || c2 < 1 || ldx < c) return (int)cudaErrorInvalidValue;
  const int vec = (c % 8 == 0) && (h % 8 == 0) && (ldx % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w1t) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w2t) % 16 == 0);
  const Args a{x, w1t, b1, w2t, b2, out, ldx, m, c, h, c2, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((c2 + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    fused_mlp_tc_kernel<<<grid, kThreads, 0, st>>>(a);
  } else if (dtype == 0) {
    const dim3 grid((c2 + kSBN - 1) / kSBN, (m + kSBM - 1) / kSBM);
    fused_mlp_simt_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bf16 operands TMA can address (the rule at the top, which the wrapper's
// _plan routes by; operands that miss it are refused here with
// cudaErrorInvalidValue). For each chunk of chunk_rows rows of x (a multiple
// of 128, or all of M), launches up into hidden [chunk_rows, H], then down
// into out [M, C2]; bn_up and bn_down are the output tiles' widths (64, 128,
// 192 or 256). Returns a cudaError_t (0 on success).
int cambrian_fused_mlp_wgmma(const void* x, int64_t ldx, const void* w1t, const float* b1,
                             const void* w2t, const float* b2, void* out, void* hidden, int m,
                             int c, int h, int c2, int chunk_rows, int bn_up, int bn_down,
                             void* stream) {
  if (m < 1 || c < 1 || h < 1 || c2 < 1 || ldx < c || chunk_rows < 1 ||
      (chunk_rows < m && chunk_rows % kGBM != 0))
    return (int)cudaErrorInvalidValue;
  if (c % 8 != 0 || h % 8 != 0 || c2 % 8 != 0 || ldx % 8 != 0 || !aligned16(x) ||
      !aligned16(w1t) || !aligned16(w2t) || !aligned16(hidden) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_w1, tm_w2;
  if (!slab_map(&tm_w1, w1t, c, h, c, bn_up) || !slab_map(&tm_w2, w2t, h, c2, h, bn_down))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(hidden);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  for (int r0 = 0; r0 < m; r0 += chunk_rows) {
    const int rows = m - r0 < chunk_rows ? m - r0 : chunk_rows;
    CUtensorMap tm_x, tm_h;
    if (!slab_map(&tm_x, xb + (int64_t)r0 * ldx, c, rows, ldx, kGBM) ||
        !slab_map(&tm_h, hb, h, rows, h, kGBM))
      return (int)cudaErrorInvalidValue;
    int err = launch_gemm_bn<true>(bn_up, tm_x, tm_w1, GemmArgs{b1, hb, h, rows, h, c}, st);
    if (err != 0) return err;
    err = launch_gemm_bn<false>(bn_down, tm_h, tm_w2,
                                GemmArgs{b2, ob + (int64_t)r0 * c2, c2, rows, c2, h}, st);
    if (err != 0) return err;
  }
  return 0;
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
