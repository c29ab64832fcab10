// Flash-attention backward for Hopper (sm_90a), with a plain C interface that
// cambrian_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel cambrian_tpu/ops/flash_attention.py::_attn_bwd_kernel
// (reached through _flash_bwd_impl's pallas_call), the backward of K1. Same
// semantics:
//   - q, o, do [B, Sq, H, D], k/v [B, Sk, KVH, D] (BQHD; head h reads kv head
//     h / (H / KVH) in place), key_valid [B, Sk];
//   - the probabilities are recomputed in fp32 from a whole-row maximum and
//     sum of the masked logits (q . k) * scale, p = exp(x - max) / max(sum,
//     1e-30), masked entries 0; a row with no live key has p = 0 throughout,
//     so its dq is 0 and it adds nothing to dk/dv;
//   - delta = rowsum(do * o) in fp32, ds = p * (do . v - delta) * scale,
//     dq = ds k, dk = ds^T q, dv = p^T do;
//   - dk/dv of a kv head sum its group of H / KVH query heads in fp32 (the JAX
//     package repeats K/V and sums the bf16 per-head dk/dv instead);
//   - outputs in the input dtype (bf16 or fp32), fp32 inside.
//
// Design. The TPU kernel keeps a (batch, head)'s whole K/V stripe and its fp32
// dk/dv accumulators in VMEM and carries them across a sequential grid of q
// blocks. Hopper blocks run in parallel in no order, so the work is split into
// three launches with no atomics, deterministic:
//   1. bwd_stats: one block per (batch, head, 64-row q tile) walks the keys and
//      keeps the row maximum and sum of the masked logits online (as K1 does),
//      and computes delta; written to fp32 [B, H, Sq] scratch;
//   2. bwd_dkdv: one block per (batch, kv head, 64-row K tile) holds its K/V
//      tile and the fp32 dk/dv accumulators, and loops over the group's query
//      heads and their q tiles, skipping the tiles the causal mask or the
//      sliding window leaves empty;
//   3. bwd_dq: one block per (batch, head, 64-row q tile) loops over the K
//      tiles and accumulates dq.
// Tiles are staged in shared memory as fp32; K/V rows are padded by one float
// so that the column walks are free of bank conflicts.
//
// What bounds it on the card: about 5 * S^2 * D multiply-adds per head
// (causal: half), which the products here run as SIMT fp32 FMAs fed from
// shared memory, not on the tensor cores; the pre-pass adds one more Q K^T.
// So it is bound by FMA throughput and shared-memory bandwidth, far below the bf16
// tensor-core rate. Moving the products to wgmma with TMA-fed tiles, and the
// statistics into K1's forward, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 grid: each thread owns 4 rows x 4 (or 8) columns
constexpr int kMaxD = 128;
constexpr int kMaxCols = kMaxD / 16;
constexpr int kLdp = kBlockK + 1;

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
  float* row_max;    // [B, H, Sq] scratch; -inf for a row with no live key
  float* row_sum;
  float* row_delta;
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

// The key range [begin, end) a q tile [q0, q0 + 64) can see, as in K1.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* begin, int* end) {
  *begin = 0;
  *end = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + kBlockQ, p.Sq) - 1 + p.q_offset;
    *end = min(*end, last_q + 1);
  }
  if (p.window > 0) *begin = max(0, q0 + p.q_offset - p.window + 1) / kBlockK * kBlockK;
}

// Stage rows [r0, r0 + rows_cap) of a [S, D] slice (stride ld_g between rows)
// into shared memory as fp32 with row stride ld_s; rows past S are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld_s, const T* src, int64_t ld_g,
                                      int r0, int S, int D) {
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, g = r0 + r;
    dst[r * ld_s + c] = g < S ? load_f32(src + g * ld_g + c) : 0.f;
  }
}

// s = A B^T and t = C E^T on 4 x 4 (row, key) pairs of a thread: rows ty*4 + r
// of A/C (row stride D), keys tx + 16 j of B/E (row stride D + 1).
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, int D, int ty, int tx,
                                             float s[4][4], float t[4][4]) {
  const int ldk = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = t[r][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4], c[4], e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A[(ty * 4 + r) * D + d];
      c[r] = C[(ty * 4 + r) * D + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * ldk + d];
      e[j] = E[(tx + 16 * j) * ldk + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = fmaf(a[r], b[j], s[r][j]);
        t[r][j] = fmaf(c[r], e[j], t[r][j]);
      }
  }
}

// p and ds of a thread's 4 x 4 (row, key) pairs, from the logits s and
// dp = do . v, written to sP / sdS ([64][65]) when given.
__device__ __forceinline__ void probs_and_ds(const Params& p, const uint8_t* valid, int q0,
                                             int k0, int ty, int tx, const float s[4][4],
                                             const float dp[4][4], const float* sM,
                                             const float* sL, const float* sDelta,
                                             float* sP, float* sdS) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const float m = sM[row];
    const float denom = fmaxf(sL[row], 1e-30f);
    const float delta = sDelta[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      float pr = 0.f;
      if (m != -INFINITY && live(p, valid, q0 + row, k0 + col))
        pr = expf(s[r][j] * p.scale - m) / denom;
      if (sP) sP[row * kLdp + col] = pr;
      sdS[row * kLdp + col] = pr * (dp[r][j] - delta) * p.scale;
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_stats(const Params& p, int b, int h, int q0, float* sM,
                                           float* sL, float* sDelta) {
  if (threadIdx.x < kBlockQ) {
    const int qi = q0 + threadIdx.x;
    const int64_t idx = ((int64_t)b * p.H + h) * p.Sq + qi;
    sM[threadIdx.x] = qi < p.Sq ? p.row_max[idx] : -INFINITY;
    sL[threadIdx.x] = qi < p.Sq ? p.row_sum[idx] : 0.f;
    sDelta[threadIdx.x] = qi < p.Sq ? p.row_delta[idx] : 0.f;
  }
}

// 1. Row statistics: maximum and sum of the masked, scaled logits; delta.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_stats_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* sQ = smem;
  float* sK = sQ + kBlockQ * D;
  float* sS = sK + kBlockK * ldk;
  float* sM = sS + kBlockQ * kLdp;
  float* sL = sM + kBlockQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBlockQ;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* O = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;
  const int64_t stat0 = ((int64_t)b * p.H + h) * p.Sq;

  stage(sQ, D, Q, p.q_ss, q0, p.Sq, D);
  if (tid < kBlockQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  // delta = rowsum(do * o): warp w owns rows 8w .. 8w + 7
  for (int rr = 0; rr < 8; ++rr) {
    const int qi = q0 + warp * 8 + rr;
    float acc = 0.f;
    if (qi < p.Sq)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(load_f32(dO + qi * p.do_ss + c), load_f32(O + qi * p.o_ss + c), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && qi < p.Sq) p.row_delta[stat0 + qi] = acc;
  }

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    stage(sK, ldk, K, p.k_ss, k0, p.Sk, D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[(ty * 4 + r) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], bk[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 4 + r, col = tx + 16 * j;
        sS[row * kLdp + col] =
            live(p, valid, q0 + row, k0 + col) ? s[r][j] * p.scale : -INFINITY;
      }
    __syncthreads();
    for (int rr = 0; rr < 8; ++rr) {
      const int row = warp * 8 + rr;
      const float x0 = sS[row * kLdp + lane], x1 = sS[row * kLdp + lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mt);
      if (m_new != -INFINITY) {
        float sum = expf(x0 - m_new) + expf(x1 - m_new);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          sL[row] = sL[row] * expf(m_old - m_new) + sum;
          sM[row] = m_new;
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (tid < kBlockQ && q0 + tid < p.Sq) {
    p.row_max[stat0 + q0 + tid] = sM[tid];
    p.row_sum[stat0 + q0 + tid] = sL[tid];
  }
}

// 2. dk, dv of one 64-row K tile of one (batch, kv head), over its group of
// query heads.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* sK = smem;
  float* sV = sK + kBlockK * ldk;
  float* sQ = sV + kBlockK * ldk;
  float* sdO = sQ + kBlockQ * D;
  float* sP = sdO + kBlockQ * D;
  float* sdS = sP + kBlockQ * kLdp;
  float* sM = sdS + kBlockQ * kLdp;
  float* sL = sM + kBlockQ;
  float* sDelta = sL + kBlockQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.KVH;
  const int kvh = blockIdx.y % p.KVH;
  const int group = p.H / p.KVH;
  const int k0 = blockIdx.x * kBlockK;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;

  stage(sK, ldk, K, p.k_ss, k0, p.Sk, D);
  stage(sV, ldk, V, p.v_ss, k0, p.Sk, D);

  float acc_dk[4][kMaxCols], acc_dv[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc_dk[r][j] = acc_dv[r][j] = 0.f;

  // the q rows that can see a key of this tile
  const int k_last = min(k0 + kBlockK, p.Sk) - 1;
  int q_begin = 0;
  int q_end = p.Sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset) / kBlockQ * kBlockQ;
  if (p.window > 0) q_end = min(q_end, k_last + p.window - p.q_offset);

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's readers are done
      stage(sQ, D, Q, p.q_ss, q0, p.Sq, D);
      stage(sdO, D, dO, p.do_ss, q0, p.Sq, D);
      load_stats<T>(p, b, h, q0, sM, sL, sDelta);
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products(sQ, sK, sdO, sV, D, ty, tx, s, dp);
      probs_and_ds(p, valid, q0, k0, ty, tx, s, dp, sM, sL, sDelta, sP, sdS);
      __syncthreads();
      // dv[k][c] += sum_q p[q][k] do[q][c];  dk[k][c] += sum_q ds[q][k] q[q][c]
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = sP[qq * kLdp + ty * 4 + r];
          dsv[r] = sdS[qq * kLdp + ty * 4 + r];
        }
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
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
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        store_as(dK + kj * p.dk_ss + c, acc_dk[r][j]);
        store_as(dV + kj * p.dv_ss + c, acc_dv[r][j]);
      }
    }
  }
}

// 3. dq of one 64-row q tile of one (batch, head).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kBlockQ * D;
  float* sK = sdO + kBlockQ * D;
  float* sV = sK + kBlockK * ldk;
  float* sdS = sV + kBlockK * ldk;
  float* sM = sdS + kBlockQ * kLdp;
  float* sL = sM + kBlockQ;
  float* sDelta = sL + kBlockQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBlockQ;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;

  stage(sQ, D, Q, p.q_ss, q0, p.Sq, D);
  stage(sdO, D, dO, p.do_ss, q0, p.Sq, D);
  load_stats<T>(p, b, h, q0, sM, sL, sDelta);

  float acc[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[r][j] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    stage(sK, ldk, K, p.k_ss, k0, p.Sk, D);
    stage(sV, ldk, V, p.v_ss, k0, p.Sk, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products(sQ, sK, sdO, sV, D, ty, tx, s, dp);
    probs_and_ds(p, valid, q0, k0, ty, tx, s, dp, sM, sL, sDelta, nullptr, sdS);
    __syncthreads();
    // dq[q][c] += sum_k ds[q][k] k[k][c]
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = sdS[(ty * 4 + r) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float kv = sK[kk * ldk + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(dsv[r], kv, acc[r][j]);
        }
      }
    }
  }

  T* dQ = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store_as(dQ + qi * p.dq_ss + c, acc[r][j]);
    }
  }
}

size_t stats_smem(int d) {
  return sizeof(float) * (size_t)(kBlockQ * d + kBlockK * (d + 1) + kBlockQ * kLdp + 2 * kBlockQ);
}
size_t dkdv_smem(int d) {
  return sizeof(float) * (size_t)(2 * kBlockK * (d + 1) + 2 * kBlockQ * d + 2 * kBlockQ * kLdp +
                                  3 * kBlockQ);
}
size_t dq_smem(int d) {
  return sizeof(float) * (size_t)(2 * kBlockQ * d + 2 * kBlockK * (d + 1) + kBlockQ * kLdp +
                                  3 * kBlockQ);
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                       const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int q_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  const int k_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  cudaError_t err = launch_one(bwd_stats_kernel<T>, dim3(q_tiles, batch * p.H),
                               stats_smem(p.D), stream, p);
  if (err != cudaSuccess) return (int)err;
  err = launch_one(bwd_dkdv_kernel<T>, dim3(k_tiles, batch * p.KVH), dkdv_smem(p.D), stream, p);
  if (err != cudaSuccess) return (int)err;
  err = launch_one(bwd_dq_kernel<T>, dim3(q_tiles, batch * p.H), dq_smem(p.D), stream, p);
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// row_max / row_sum / row_delta: fp32 scratch of B * H * Sq floats each.
int cambrian_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const uint8_t* key_valid,
    const void* o, const void* dout, void* dq, void* dk, void* dv,
    float* row_max, float* row_sum, float* row_delta,
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
  Params p{q, k, v, key_valid, o, dout, dq, dk, dv, row_max, row_sum, row_delta,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
           heads, kv_heads, s_q, s_k, head_dim, scale, causal, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, batch, st);
  return (int)cudaErrorInvalidValue;
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
