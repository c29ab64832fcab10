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
// or absent. The [M, H] hidden never reaches device memory.
//
// What bounds it on the card: at the shapes it is built for (ConvNeXt's
// C -> 4C -> C pairs, M in the thousands) the operations, on the tensor
// cores. With bf16 inputs both products run on mma.sync m16n8k16 (bf16 in,
// fp32 sums). fp32 inputs take a SIMT path on the CUDA cores.
//
// The design, and its one compromise. The TPU kernel keeps a
// [block_m, C2] fp32 accumulator in VMEM across the hidden axis. At
// ConvNeXt-XXL stage 3 (C2 = 3072) a 64-row accumulator is 768 KB, over the
// 227 KB of shared memory a Hopper block can have. So a block here owns a
// 64 x 256 output tile, held in registers (64 fp32 a thread), and walks the
// hidden axis in 64-wide chunks: for each chunk it computes the [64, 64]
// hidden slab from x and W1 (all of C), applies bias and GELU, rounds it to
// bf16 into shared memory, and multiplies it into its output tile. Blocks
// of the same rows but other output tiles compute the same hidden slab again:
// the first product is done ceil(C2 / 256) times (1 to 12 times at the
// ConvNeXt and SVA shapes). That buys a kernel with no hidden in device
// memory, no atomics and a deterministic result. The other way (one block
// holds the hidden tile and sweeps all C2 tiles, adding into an fp32 partial
// output it owns) would have to keep that [64, C2] partial in device memory
// and read and write it once per hidden chunk, far more bytes than the
// hidden it avoids. Sharing the hidden slab across a cluster of blocks
// through distributed shared memory, and wgmma with TMA-fed tiles, are later
// work. Tiles are staged without double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Abramowitz-Stegun 7.1.26, as cambrian_tpu/ops/fused_mlp.py:_erf
__device__ __forceinline__ float erf_as(float x) {
  const float p = 0.3275911f;
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float r = 1.0f - poly * expf(-ax * ax);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erf_as(v * 0.7071067811865476f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, the weights and out alike). b1 and b2
// may be null. Returns a cudaError_t (0 on success).
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

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
