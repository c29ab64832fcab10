// Flash-attention backward for Hopper (sm_90a), with a plain C interface that
// cambrian_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel cambrian_tpu/ops/flash_attention.py::_attn_bwd_kernel
// (reached through _flash_bwd_impl's pallas_call), the backward of K1. Same
// semantics:
//   - q, o, do [B, Sq, H, D], k/v [B, Sk, KVH, D] (BQHD; head h reads kv head
//     h / (H / KVH) in place), key_valid [B, Sk];
//   - the probabilities are the whole-row softmax of the masked logits
//     (q . k) * scale, here p = exp(x - lse) from the row's log-sum-exp that
//     the forward (flash_attention.cu) wrote; masked entries are 0 by
//     predicate; a row with no live key has lse = +inf, so p = 0 throughout,
//     its dq is 0 and it adds nothing to dk/dv;
//   - delta = rowsum(do * o) in fp32, ds = p * (do . v - delta) * scale,
//     dq = ds k, dk = ds^T q, dv = p^T do;
//   - dk/dv of a kv head sum its group of H / KVH query heads in fp32 (the JAX
//     package repeats K/V and sums the bf16 per-head dk/dv instead);
//   - outputs in the input dtype (bf16 or fp32), fp32 inside.
//
// The TPU kernel keeps a (batch, head)'s whole K/V stripe and its fp32 dk/dv
// accumulators in VMEM and carries them across a sequential grid of q blocks.
// Hopper blocks run in parallel in no order, so the work is three launches
// with no atomics, deterministic:
//   1. bwd_delta: delta = rowsum(do * o), one warp a row (bytes-bound);
//   2. dk/dv: one block per (batch, kv head, 64-row K tile) holds its K/V tile
//      and the fp32 dk/dv accumulators, and loops over the group's query heads
//      and their q tiles, skipping the tiles the causal mask or the sliding
//      window leaves empty; a K tile with no valid key writes zeros;
//   3. dq: one block per (batch, head, 64-row q tile) loops over the live K
//      tiles and accumulates dq.
// Splitting dk/dv from dq costs 7 products a live tile pair instead of 5
// (Q K^T and dO V^T run in both); that is the price of having no atomics.
//
// bf16: the tensor-core kernels. One warpgroup computes, one producer warp
// loads; the resident tiles and a two-stage ring of the walked tiles arrive
// by TMA (hopper.cuh) on mbarriers. In dk/dv the key tile is wgmma's M side:
// S^T = K Q^T and dP^T = V dO^T (both operands in shared memory, K-major)
// leave P^T and dS^T in registers, rounded to bf16, as the register A operand
// of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major through the
// transpose bit). dq: S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
// P and dS are rounded to bf16 before their products (the JAX backward keeps
// them in fp32); the products accumulate in fp32.
// What bounds it: 7 products of 2 * D operations a live (query, key) pair on
// the bf16 tensor cores, with the exponentials and masks between them on the
// CUDA cores of the same warpgroup. The dk/dv kernel holds two fp32 [64, D]
// accumulators, S^T, dP^T and their bf16 copies: 255 registers at D = 128,
// so one block an SM.
//
// Head dimensions up to 256 (Gemma-7B's). Above D = 128 the two fp32
// [64, D] accumulators of dK and dV would take 256 registers a thread, more
// than a thread has, so the dk/dv step is two launches of the same kernel
// function: one accumulates dV alone (S^T -> P^T, dV += P^T dO), the other
// dK alone (S^T and dP^T -> dS^T, dK += dS^T Q). Each holds one [64, D]
// accumulator (128 registers at D = 256) beside S^T and dP^T, as the dq
// kernel does. That is 8 products a live pair instead of 7 (S^T twice) and
// one more launch behind the call, still without atomics; the other form, two
// consumer warpgroups each holding half of dK's and dV's columns and
// exchanging P^T and dS^T through shared memory, keeps 7 but needs named
// barriers between the warpgroups. At DP = 256 a block's resident K and V
// (or Q and dO) tiles and two stages of the walked pair take 192 KB of shared
// memory. Products into a [64, DP] accumulator take one m64n{DP}k16 up to 128
// and at 256, and an m64n128k16 and a narrower one between (wgmma_rs_tile).
//
// fp32: SIMT FMAs on tiles staged as fp32 in shared memory (rows of K/V padded
// by one float against bank conflicts), exact to fp32 rounding. Up to D = 128
// a block takes 64-row q tiles, each thread 8 columns; above, 32-row q tiles
// and 16 columns a thread, so that the tiles fit in shared memory (214,016
// bytes for dk/dv and 205,696 for dq at D = 256).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // fp32 kernels: a 16 x 16 grid of threads
constexpr int kMaxD = 256;
constexpr int kLdp = kBlockK + 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;                          // bf16 kernels: the walked tiles' ring
constexpr int kConsumerThreads = 128;               // one warpgroup
constexpr int kTcThreads = kConsumerThreads + 32;   // and a producer warp

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* key_valid;  // [B, Sk] contiguous, or null: every key valid
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;          // [B, H, Sq] from the forward; +inf for a row with no live key
  float* delta;              // [B, H, Sq] scratch
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int H, KVH, Sq, Sk, D;
  float scale;
  int causal;
  int window;  // <= 0: no sliding window
  int q_offset;
};

// Whether query row qi may attend to key kj (K1's mask: key validity, causal
// and sliding-window predicates on q_pos = qi + q_offset).
__device__ __forceinline__ bool live(const Params& p, const uint8_t* valid, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Sk) return false;
  const int q_pos = qi + p.q_offset;
  if (p.causal && kj > q_pos) return false;
  if (p.window > 0 && q_pos - kj >= p.window) return false;
  return valid == nullptr || valid[kj] != 0;
}

// The key range [begin, end) a q tile [q0, q0 + rows) can see, as in K1.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* begin, int* end,
                                          int rows = kBlockQ) {
  *begin = 0;
  *end = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + rows, p.Sq) - 1 + p.q_offset;
    *end = min(*end, last_q + 1);
  }
  if (p.window > 0) *begin = max(0, q0 + p.q_offset - p.window + 1) / kBlockK * kBlockK;
}

// The q range [begin, end) that can see a key of the tile [k0, k0 + 64);
// begin is tile-aligned.
__device__ __forceinline__ void query_range(const Params& p, int k0, int* begin, int* end) {
  const int k_last = min(k0 + kBlockK, p.Sk) - 1;
  *begin = 0;
  *end = p.Sq;
  if (p.causal) *begin = max(0, k0 - p.q_offset) / kBlockQ * kBlockQ;
  if (p.window > 0) *end = min(*end, k_last + p.window - p.q_offset);
}

// 1. delta = rowsum(do * o): one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_delta_kernel(Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int qi = blockIdx.x * (kThreads / 32) + warp;
  if (qi >= p.Sq) return;
  const T* O = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + qi * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(load_f32(dO + c), load_f32(O + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((int64_t)b * p.H + h) * p.Sq + qi] = acc;
}

// -- fp32: SIMT ---------------------------------------------------------------
//
// A block's threads form a 16 x 16 grid (ty, tx). kRows: the rows of a q tile
// (64, or 32 above D = 128), R = kRows / 16 of them a thread (ty * R + r);
// each thread takes 4 keys of the 64-key tile (tx + 16 j) in the products,
// and kCols head-dimension columns (tx + 16 j) of its accumulators: 8 up to
// D = 128, 16 above.

// Stage rows [r0, r0 + rows) of a [S, D] slice (stride ld_g between rows)
// into shared memory as fp32 with row stride ld_s; rows past S are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld_s, const T* src, int64_t ld_g,
                                      int r0, int rows, int S, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, g = r0 + r;
    dst[r * ld_s + c] = g < S ? load_f32(src + g * ld_g + c) : 0.f;
  }
}

// s = A B^T and t = C E^T on R x 4 (row, key) pairs of a thread: rows ty*R + r
// of A/C (row stride D), keys tx + 16 j of B/E (row stride D + 1).
template <int R>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, int D, int ty, int tx,
                                             float s[R][4], float t[R][4]) {
  const int ldk = D + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = t[r][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[R], b[4], c[R], e[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = A[(ty * R + r) * D + d];
      c[r] = C[(ty * R + r) * D + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * ldk + d];
      e[j] = E[(tx + 16 * j) * ldk + d];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = fmaf(a[r], b[j], s[r][j]);
        t[r][j] = fmaf(c[r], e[j], t[r][j]);
      }
  }
}

// p and ds of a thread's R x 4 (row, key) pairs, from the logits s and
// dp = do . v, written to sP / sdS ([rows][65]) when given.
template <int R>
__device__ __forceinline__ void probs_and_ds(const Params& p, const uint8_t* valid, int q0,
                                             int k0, int ty, int tx, const float s[R][4],
                                             const float dp[R][4], const float* sLse,
                                             const float* sDelta, float* sP, float* sdS) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ty * R + r;
    const float lse = sLse[row];
    const float delta = sDelta[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      float pr = 0.f;
      if (live(p, valid, q0 + row, k0 + col)) pr = expf(s[r][j] * p.scale - lse);
      if (sP) sP[row * kLdp + col] = pr;
      sdS[row * kLdp + col] = pr * (dp[r][j] - delta) * p.scale;
    }
  }
}

__device__ __forceinline__ void load_stats(const Params& p, int b, int h, int q0, int rows,
                                           float* sLse, float* sDelta) {
  if (threadIdx.x < rows) {
    const int qi = q0 + threadIdx.x;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + qi;
    sLse[threadIdx.x] = qi < p.Sq ? p.lse[idx] : INFINITY;
    sDelta[threadIdx.x] = qi < p.Sq ? p.delta[idx] : 0.f;
  }
}

// 2. dk, dv of one 64-row K tile of one (batch, kv head), over its group of
// query heads.
template <typename T, int kRows, int kCols>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Params p) {
  constexpr int R = kRows / 16;
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* sK = smem;
  float* sV = sK + kBlockK * ldk;
  float* sQ = sV + kBlockK * ldk;
  float* sdO = sQ + kRows * D;
  float* sP = sdO + kRows * D;
  float* sdS = sP + kRows * kLdp;
  float* sLse = sdS + kRows * kLdp;
  float* sDelta = sLse + kRows;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.KVH;
  const int kvh = blockIdx.y % p.KVH;
  const int group = p.H / p.KVH;
  const int k0 = blockIdx.x * kBlockK;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;

  stage(sK, ldk, K, p.k_ss, k0, kBlockK, p.Sk, D);
  stage(sV, ldk, V, p.v_ss, k0, kBlockK, p.Sk, D);

  // this thread's keys ty * 4 + r of the tile, columns tx + 16 j
  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[r][j] = acc_dv[r][j] = 0.f;

  int q_begin, q_end;
  query_range(p, k0, &q_begin, &q_end);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += kRows) {
      __syncthreads();  // the previous tile's readers are done
      stage(sQ, D, Q, p.q_ss, q0, kRows, p.Sq, D);
      stage(sdO, D, dO, p.do_ss, q0, kRows, p.Sq, D);
      load_stats(p, b, h, q0, kRows, sLse, sDelta);
      __syncthreads();
      float s[R][4], dp[R][4];
      two_products<R>(sQ, sK, sdO, sV, D, ty, tx, s, dp);
      probs_and_ds<R>(p, valid, q0, k0, ty, tx, s, dp, sLse, sDelta, sP, sdS);
      __syncthreads();
      // dv[k][c] += sum_q p[q][k] do[q][c];  dk[k][c] += sum_q ds[q][k] q[q][c]
      for (int qq = 0; qq < kRows; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = sP[qq * kLdp + ty * 4 + r];
          dsv[r] = sdS[qq * kLdp + ty * 4 + r];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tx + 16 * j;
          if (c < D) {
            const float dov = sdO[qq * D + c];
            const float qv = sQ[qq * D + c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc_dv[r][j] = fmaf(pv[r], dov, acc_dv[r][j]);
              acc_dk[r][j] = fmaf(dsv[r], qv, acc_dk[r][j]);
            }
          }
        }
      }
    }
  }

  T* dK = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dV = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty * 4 + r;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        store_as(dK + kj * p.dk_ss + c, acc_dk[r][j]);
        store_as(dV + kj * p.dv_ss + c, acc_dv[r][j]);
      }
    }
  }
}

// 3. dq of one kRows-row q tile of one (batch, head).
template <typename T, int kRows, int kCols>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  constexpr int R = kRows / 16;
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kRows * D;
  float* sK = sdO + kRows * D;
  float* sV = sK + kBlockK * ldk;
  float* sdS = sV + kBlockK * ldk;
  float* sLse = sdS + kRows * kLdp;
  float* sDelta = sLse + kRows;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kRows;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;

  stage(sQ, D, Q, p.q_ss, q0, kRows, p.Sq, D);
  stage(sdO, D, dO, p.do_ss, q0, kRows, p.Sq, D);
  load_stats(p, b, h, q0, kRows, sLse, sDelta);

  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end, kRows);
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    stage(sK, ldk, K, p.k_ss, k0, kBlockK, p.Sk, D);
    stage(sV, ldk, V, p.v_ss, k0, kBlockK, p.Sk, D);
    __syncthreads();
    float s[R][4], dp[R][4];
    two_products<R>(sQ, sK, sdO, sV, D, ty, tx, s, dp);
    probs_and_ds<R>(p, valid, q0, k0, ty, tx, s, dp, sLse, sDelta, nullptr, sdS);
    __syncthreads();
    // dq[q][c] += sum_k ds[q][k] k[k][c]
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dsv[r] = sdS[(ty * R + r) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float kv = sK[kk * ldk + c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(dsv[r], kv, acc[r][j]);
        }
      }
    }
  }

  T* dQ = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + ty * R + r;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store_as(dQ + qi * p.dq_ss + c, acc[r][j]);
    }
  }
}

// Shared memory of the fp32 kernels at head_dim d with q tiles of `rows`.
size_t dkdv_smem(int d, int rows) {
  return sizeof(float) * (size_t)(2 * kBlockK * (d + 1) + 2 * rows * d + 2 * rows * kLdp +
                                  2 * rows);
}
size_t dq_smem(int d, int rows) {
  return sizeof(float) * (size_t)(2 * rows * d + 2 * kBlockK * (d + 1) + rows * kLdp +
                                  2 * rows);
}

// -- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;

// One fp32 accumulator fragment pair (two adjacent columns) as bf16.
__device__ __forceinline__ void store_pair(bf16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

template <int DP>
struct DkdvSmem {
  bf16 k[DP * kBlockK];  // resident
  bf16 v[DP * kBlockK];
  bf16 q[kStages][DP * kBlockQ];  // walked
  bf16 dout[kStages][DP * kBlockQ];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// What a dk/dv kernel function accumulates: dK and dV (DP <= 128), or, above
// DP = 128, dV alone or dK alone (two launches; see the top of the file).
constexpr int kDkDv = 0;
constexpr int kDvOnly = 1;
constexpr int kDkOnly = 2;

template <int DP, int kOut>
__global__ void __launch_bounds__(kTcThreads) bwd_dkdv_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    Params p) {
  using namespace hopper;
  constexpr bool kDv = kOut != kDkOnly;  // accumulates dV: needs P^T
  constexpr bool kDk = kOut != kDvOnly;  // accumulates dK: needs dS^T, so dP^T and V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DkdvSmem<DP>& sm = *reinterpret_cast<DkdvSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH, group = p.H / p.KVH;
  const int k0 = blockIdx.x * kBlockK;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;
  bf16* dK = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  bf16* dV = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;

  if (!tile_has_valid_key(valid, k0, p.Sk)) {
    // no valid key in the tile: no row sees it, dk = dv = 0
    const int pairs = p.D / 2;
    for (int i = tid; i < kBlockK * pairs; i += kTcThreads) {
      const int kj = k0 + i / pairs, c = 2 * (i % pairs);
      if (kj < p.Sk) {
        if (kDk) store_pair(dK + kj * p.dk_ss + c, 0.f, 0.f);
        if (kDv) store_pair(dV + kj * p.dv_ss + c, 0.f, 0.f);
      }
    }
    return;
  }

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int q_begin, q_end;
  query_range(p, k0, &q_begin, &q_end);

  if (warp == kConsumerThreads / 32) {
    // producer: K (and V, for dK) once, then Q and dO of each head of the
    // group and each q tile that can see the key tile
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, (kDk ? 2 : 1) * Tile<DP>::kBytes);
      tma_load_tile<DP>(sm.k, &tm_k, &sm.kv_full, k0, kvh, b);
      if (kDk) tma_load_tile<DP>(sm.v, &tm_v, &sm.kv_full, k0, kvh, b);
      int stage = 0, phase = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = kvh * group + hh;
        for (int q0 = q_begin; q0 < q_end; q0 += kBlockQ) {
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_expect_tx(&sm.full[stage], 2 * Tile<DP>::kBytes);
          tma_load_tile<DP>(sm.q[stage], &tm_q, &sm.full[stage], q0, h, b);
          tma_load_tile<DP>(sm.dout[stage], &tm_do, &sm.full[stage], q0, h, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread's rows (keys) are row0 and row0 + 8 of the
  // tile, its columns (queries) col0 and col0 + 1 of each 8-column group
  const int row0 = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int kj[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + row0 + 8 * r;
    key_ok[r] = kj[r] < p.Sk && (valid == nullptr || valid[kj[r]] != 0);
  }
  // the accumulators this function keeps (one float stands in for the other)
  float dk[kDk ? DP / 2 : 1], dv[kDv ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kDk ? DP / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDv ? DP / 2 : 1); ++i) dv[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  int stage = 0, phase = 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* lse_h = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta_h = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBlockQ) {
      mbar_wait(&sm.full[stage], phase);

      // S^T = K Q^T and, for dK, dP^T = V dO^T
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(st, desc_k_major<DP>(sm.k, kk), desc_k_major<DP>(sm.q[stage], kk), 1);
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n64(dpt, desc_k_major<DP>(sm.v, kk), desc_k_major<DP>(sm.dout[stage], kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T scale - lse), masked; dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + col0 + e;
          const bool in = qi < p.Sq;
          const float lse = lse_h[min(qi, p.Sq - 1)];  // unused past Sq
          const float delta = kDk ? delta_h[min(qi, p.Sq - 1)] : 0.f;
          const int q_pos = qi + p.q_offset;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = in & key_ok[r] & in_window(p.causal, p.window, q_pos, kj[r]);
            const int i = 4 * j + 2 * r + e;
            const float pt = ok ? exp2_approx((st[i] * p.scale - lse) * kLog2e) : 0.f;
            st[i] = pt;
            dpt[i] = pt * (dpt[i] - delta) * p.scale;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T in bf16 from registers
      uint32_t a_p[4][4], a_ds[4][4];
      if constexpr (kDv) acc_to_a(st, a_p);
      if constexpr (kDk) acc_to_a(dpt, a_ds);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      if constexpr (kDv) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<DP>(dv, a_p[kk], sm.dout[stage], kk);
      }
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<DP>(dk, a_ds[kk], sm.q[stage], kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&sm.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col0;
      if (c < p.D) {
        if constexpr (kDk)
          store_pair(dK + kj[r] * p.dk_ss + c, dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        if constexpr (kDv)
          store_pair(dV + kj[r] * p.dv_ss + c, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
struct DqSmem {
  bf16 q[DP * kBlockQ];  // resident
  bf16 dout[DP * kBlockQ];
  bf16 k[kStages][DP * kBlockK];  // walked
  bf16 v[kStages][DP * kBlockK];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads) bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    Params p) {
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DqSmem<DP>& sm = *reinterpret_cast<DqSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBlockQ;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;
  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer: Q and dO once, then the live K/V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, 2 * Tile<DP>::kBytes);
      tma_load_tile<DP>(sm.q, &tm_q, &sm.q_full, q0, h, b);
      tma_load_tile<DP>(sm.dout, &tm_do, &sm.q_full, q0, h, b);
    }
    int stage = 0, phase = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
      if (!tile_has_valid_key(valid, k0, p.Sk)) continue;
      if (lane == 0) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full[stage], 2 * Tile<DP>::kBytes);
        tma_load_tile<DP>(sm.k[stage], &tm_k, &sm.full[stage], k0, kvh, b);
        tma_load_tile<DP>(sm.v[stage], &tm_v, &sm.full[stage], k0, kvh, b);
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup: rows (queries) row0 and row0 + 8, columns (keys)
  // col0 and col0 + 1 of each 8-column group
  const int row0 = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int qi[2], q_pos[2];
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + row0 + 8 * r;
    q_pos[r] = qi[r] + p.q_offset;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + qi[r];
    lse[r] = qi[r] < p.Sq ? p.lse[idx] : INFINITY;
    delta[r] = qi[r] < p.Sq ? p.delta[idx] : 0.f;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  mbar_wait(&sm.q_full, 0);
  int stage = 0, phase = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    if (!tile_has_valid_key(valid, k0, p.Sk)) continue;
    mbar_wait(&sm.full[stage], phase);

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, desc_k_major<DP>(sm.q, kk), desc_k_major<DP>(sm.k[stage], kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, desc_k_major<DP>(sm.dout, kk), desc_k_major<DP>(sm.v[stage], kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) scale, P = exp(S scale - lse) masked (no branches)
    const uint32_t bad = invalid_key_bits(valid, k0, col0, p.Sk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + col0 + e;
        const bool key_ok = (kj < p.Sk) & !((bad >> (2 * j + e)) & 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok =
              key_ok & (qi[r] < p.Sq) & in_window(p.causal, p.window, q_pos[r], kj);
          const int i = 4 * j + 2 * r + e;
          const float pr = ok ? exp2_approx((sc[i] * p.scale - lse[r]) * kLog2e) : 0.f;
          sc[i] = pr * (dp[i] - delta[r]) * p.scale;
        }
      }
    }

    // dQ += dS K, dS in bf16 from registers, K read MN-major
    uint32_t a_ds[4][4];
    acc_to_a(sc, a_ds);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<DP>(dq, a_ds[kk], sm.k[stage], kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    mbar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  bf16* dQ = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col0;
      if (c < p.D) store_pair(dQ + qi[r] * p.dq_ss + c, dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// -- launches -------------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                       Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const Params& p, int batch, cudaStream_t stream) {
  const int rows = kThreads / 32;
  return launch_one(bwd_delta_kernel<T>, dim3((p.Sq + rows - 1) / rows, batch * p.H), kThreads,
                    0, stream, p);
}

template <int kRows, int kCols>
int launch_f32_tiles(const Params& p, int batch, cudaStream_t stream) {
  const int q_tiles = (p.Sq + kRows - 1) / kRows;
  const int k_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  cudaError_t err = launch_delta<float>(p, batch, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_one(bwd_dkdv_kernel<float, kRows, kCols>, dim3(k_tiles, batch * p.KVH), kThreads,
                   dkdv_smem(p.D, kRows), stream, p);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_one(bwd_dq_kernel<float, kRows, kCols>, dim3(q_tiles, batch * p.H),
                         kThreads, dq_smem(p.D, kRows), stream, p);
}

int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  return p.D <= 128 ? launch_f32_tiles<64, 8>(p, batch, stream)
                    : launch_f32_tiles<32, 16>(p, batch, stream);
}

template <int DP>
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  using hopper_host::bf16_tile_map;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!bf16_tile_map(&tm_q, p.q, batch, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, DP) ||
      !bf16_tile_map(&tm_k, p.k, batch, p.Sk, p.KVH, p.D, p.k_sb, p.k_ss, p.k_sh, DP) ||
      !bf16_tile_map(&tm_v, p.v, batch, p.Sk, p.KVH, p.D, p.v_sb, p.v_ss, p.v_sh, DP) ||
      !bf16_tile_map(&tm_do, p.dout, batch, p.Sq, p.H, p.D, p.do_sb, p.do_ss, p.do_sh, DP))
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  const int k_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  const dim3 kv_grid(k_tiles, batch * p.KVH);
  const size_t kv_smem = sizeof(DkdvSmem<DP>);
  cudaError_t err = launch_delta<bf16>(p, batch, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (DP <= 128) {
    err = launch_one(bwd_dkdv_bf16_kernel<DP, kDkDv>, kv_grid, kTcThreads, kv_smem, stream, tm_q,
                     tm_k, tm_v, tm_do, p);
  } else {
    err = launch_one(bwd_dkdv_bf16_kernel<DP, kDvOnly>, kv_grid, kTcThreads, kv_smem, stream,
                     tm_q, tm_k, tm_v, tm_do, p);
    if (err != cudaSuccess) return (int)err;
    err = launch_one(bwd_dkdv_bf16_kernel<DP, kDkOnly>, kv_grid, kTcThreads, kv_smem, stream,
                     tm_q, tm_k, tm_v, tm_do, p);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_one(bwd_dq_bf16_kernel<DP>, dim3(q_tiles, batch * p.H), kTcThreads,
                         sizeof(DqSmem<DP>), stream, tm_q, tm_k, tm_v, tm_do, p);
}

int launch_bf16_any(const Params& p, int batch, cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_bf16<16>(p, batch, stream);
    case 2: return launch_bf16<32>(p, batch, stream);
    case 3: return launch_bf16<48>(p, batch, stream);
    case 4: return launch_bf16<64>(p, batch, stream);
    case 5: return launch_bf16<80>(p, batch, stream);
    case 6: return launch_bf16<96>(p, batch, stream);
    case 7: return launch_bf16<112>(p, batch, stream);
    case 8: return launch_bf16<128>(p, batch, stream);
    case 9: return launch_bf16<144>(p, batch, stream);
    case 10: return launch_bf16<160>(p, batch, stream);
    case 11: return launch_bf16<176>(p, batch, stream);
    case 12: return launch_bf16<192>(p, batch, stream);
    case 13: return launch_bf16<208>(p, batch, stream);
    case 14: return launch_bf16<224>(p, batch, stream);
    case 15: return launch_bf16<240>(p, batch, stream);
    case 16: return launch_bf16<256>(p, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor-core kernels;
// head_dim a multiple of 8, 16-byte aligned bases and strides). lse: the
// forward's fp32 [B, H, Sq] row statistic; delta: fp32 scratch of B * H * Sq.
// Returns a cudaError_t (0 on success).
int cambrian_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const uint8_t* key_valid,
    const void* o, const void* dout, void* dq, void* dk, void* dv,
    const float* lse, float* delta,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int batch, int heads, int kv_heads, int s_q, int s_k, int head_dim,
    float scale, int causal, int window, int q_offset, void* stream) {
  if (head_dim < 1 || head_dim > kMaxD || kv_heads < 1 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, key_valid, o, dout, dq, dk, dv, lse, delta,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
           heads, kv_heads, s_q, s_k, head_dim, scale, causal, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, batch, st);
  if (dtype == 1 && head_dim % 8 == 0) return launch_bf16_any(p, batch, st);
  return (int)cudaErrorInvalidValue;
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
