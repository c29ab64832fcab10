// Flash-attention forward for Hopper (sm_90a), with a plain C interface that
// cambrian_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel cambrian_tpu/ops/flash_attention.py::_attn_kernel
// (reached through _flash_fwd_impl's pallas_call). Same semantics:
//   - q [B, Sq, H, D], k/v [B, Sk, KVH, D] (BQHD; head h reads kv head
//     h / (H / KVH) in place, no repeated copy of K/V), key_valid [B, Sk];
//   - fp32 logits and softmax, logits = (q . k) * scale;
//   - causal / sliding-window predicates on q_pos = q_offset + i replace the
//     logit with NEG_INF; an invalid key then adds NEG_INF on top, which
//     overflows to -inf for a key that is masked twice, as on the TPU;
//   - a row whose running maximum never rises above NEG_INF / 2 (no key
//     survives) is written as 0 through a select, never NaN;
//   - output in the input dtype (bf16 or fp32).
// On request it also writes each row's log-sum-exp of the masked logits
// (fp32 [B, H, Sq]; +inf for a row with no live key), which the backward
// (flash_attention_bwd.cu) reads instead of recomputing the row statistics.
//
// The TPU kernel keeps the whole K/V stripe of a (batch, head) in VMEM and
// does one row-complete softmax. A Hopper block has at most 227 KB of shared
// memory, so here one block owns a 64-row q tile of one (batch, head) and
// walks the keys in 64-row tiles with an online softmax (running row maximum
// and sum, the output rescaled when the maximum moves). Key tiles past the q
// tile's last causal position or before its sliding window are skipped.
//
// bf16: the tensor-core kernel. One warpgroup computes, one producer warp
// loads. Q stays in shared memory; K/V tiles arrive through a two-stage ring
// loaded by TMA (tensor maps built on the host from the strides; swizzled
// chunks of 32-, 64- or 128-byte rows, the head dimension padded with zeros
// to a multiple of 16; see hopper.cuh) and completed on mbarriers. S = Q K^T
// is a wgmma m64n64k16 chain with both operands in shared memory; the mask
// and the online softmax run on the fp32 accumulator fragments in registers
// (row maximum and sum by quad shuffles); P is rounded to bf16 in registers
// (as the TPU kernel rounds its probabilities to v.dtype) and is the register
// A operand of O += P V, with V read MN-major through the transpose bit. A
// key tile whose keys are all invalid is skipped too (a warp vote): it adds
// exactly 0 to a live row.
// The mask is selects on the fragments, not branches: a branch a fragment
// element kept the compiler from overlapping the elements' exponentials and
// cost half the kernel's time.
// What bounds it: the two products are 4 * D operations a live (query, key)
// pair on the bf16 tensor cores, but one warpgroup waits for each product
// before the next step, so the tensor cores idle while it computes the
// exponentials; at the serving shapes (~2.5 GFLOP a call) there are only
// 160-352 blocks for 132 SMs to hide that.
//
// Head dimensions up to 256 (Gemma-7B's). The bf16 kernel is instantiated
// for every padded width DP = 16 .. 256 in steps of 16; at DP = 256 a q tile,
// two K and two V tiles take 160 KB of shared memory (one block an SM), and
// one consumer thread holds O's 64 x 256 fp32 tile as 128 registers beside
// S's 32. P V is one m64n256k16 a k16 step at DP = 256 and, between 128 and
// 256, an m64n128k16 and a narrower one (hopper.cuh, wgmma_rs_tile).
//
// fp32: SIMT FMAs on tiles converted to fp32 in shared memory, exact to fp32
// rounding; it carries the card-vs-CPU parity of the fp32 paths. At D = 256
// its tiles take 214,272 bytes of shared memory.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // fp32 kernel: a 16 x 16 grid, each thread owns 4 q rows
constexpr int kMaxD = 256;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // NEG_INF of the JAX package
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;                            // bf16 kernel: K/V ring
constexpr int kConsumerThreads = 128;                 // one warpgroup
constexpr int kTcThreads = kConsumerThreads + 32;     // and a producer warp

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
  void* o;
  float* lse;                // [B, H, Sq], or null: not wanted
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, KVH, Sq, Sk, D;
  float scale;
  int causal;
  int window;  // <= 0: no sliding window
  int q_offset;
};

// The key range [begin, end) a q tile [q0, q0 + 64) can see; begin is
// tile-aligned.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* begin, int* end) {
  *begin = 0;
  *end = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + kBlockQ, p.Sq) - 1 + p.q_offset;
    *end = min(*end, last_q + 1);
  }
  if (p.window > 0) *begin = max(0, q0 + p.q_offset - p.window + 1) / kBlockK * kBlockK;
}

__device__ __forceinline__ float row_lse(float m, float l) {
  return m > 0.5f * kNegInf ? m + logf(l) : INFINITY;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kBlockQ * d            // Q tile
                                  + kBlockK * (d + 1)     // K tile, padded rows
                                  + kBlockK * d           // V tile
                                  + kBlockQ * (kBlockK + 1)  // logits / probs
                                  + 3 * kBlockQ);         // max, sum, rescale
}

// kCols: output columns a thread holds (16 kCols >= D): 8 up to D = 128, 16
// above, so that the head dimensions up to 128 keep their registers.
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  const int ldp = kBlockK + 1;
  float* sQ = smem;
  float* sK = sQ + kBlockQ * D;
  float* sV = sK + kBlockK * ldk;
  float* sP = sV + kBlockK * D;
  float* sM = sP + kBlockQ * ldp;
  float* sL = sM + kBlockQ;
  float* sA = sL + kBlockQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBlockQ;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    sQ[i] = qi < p.Sq ? load_f32(Q + qi * p.q_ss + c) : 0.f;
  }
  if (tid < kBlockQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);

  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool in = kj < p.Sk;
      sK[r * ldk + c] = in ? load_f32(K + kj * p.k_ss + c) : 0.f;
      sV[r * D + c] = in ? load_f32(V + kj * p.v_ss + c) : 0.f;
    }
    __syncthreads();

    // logits for rows ty*4 + r, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty * 4 + r) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q_pos = q0 + ty * 4 + r + p.q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x;
        if (kj >= p.Sk) {
          x = -INFINITY;  // past the keys: contributes nothing
        } else {
          x = s[r][j] * p.scale;
          bool keep = true;
          if (p.causal) keep = kj <= q_pos;
          if (p.window > 0) keep = keep && (q_pos - kj < p.window);
          if (!keep) x = kNegInf;
          if (valid && !valid[kj]) x = x + kNegInf;
        }
        sP[(ty * 4 + r) * ldp + tx + 16 * j] = x;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, each lane two keys
    for (int rr = 0; rr < 8; ++rr) {
      const int row = warp * 8 + rr;
      float* prow = sP + row * ldp;
      const float a = prow[lane], c = prow[lane + 32];
      float mt = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mt);
      float pa = 0.f, pc = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        pa = expf(a - m_new);
        pc = expf(c - m_new);
        alpha = expf(m_old - m_new);
      }
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      prow[lane] = pa;
      prow[lane + 32] = pc;
      __syncwarp();
      if (lane == 0) {
        sL[row] = sL[row] * alpha + sum;
        sM[row] = m_new;
        sA[row] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = sA[ty * 4 + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= alpha;
    }
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty * 4 + r) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float vv = sV[kk * D + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const int qi = q0 + row;
    if (qi >= p.Sq) continue;
    const bool alive = sM[row] > 0.5f * kNegInf;
    const float inv = 1.f / fmaxf(sL[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store_as(O + qi * p.o_ss + c, alive ? acc[r][j] * inv : 0.f);
    }
  }
  if (p.lse != nullptr && tid < kBlockQ && q0 + tid < p.Sq)
    p.lse[((int64_t)b * p.H + h) * p.Sq + q0 + tid] = row_lse(sM[tid], sL[tid]);
}

// -- bf16: tensor cores -------------------------------------------------------

template <int DP>
struct FwdSmem {
  __nv_bfloat16 q[DP * kBlockQ];
  __nv_bfloat16 k[kStages][DP * kBlockK];
  __nv_bfloat16 v[kStages][DP * kBlockK];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads) fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, Params p) {
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  FwdSmem<DP>& s = *reinterpret_cast<FwdSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBlockQ;
  const uint8_t* valid = p.key_valid ? p.key_valid + (int64_t)b * p.Sk : nullptr;
  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);

  if (tid == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // producer: Q once, then the live K/V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(&s.q_full, Tile<DP>::kBytes);
      tma_load_tile<DP>(s.q, &tm_q, &s.q_full, q0, h, b);
    }
    int stage = 0, phase = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
      if (!tile_has_valid_key(valid, k0, p.Sk)) continue;
      if (lane == 0) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], 2 * Tile<DP>::kBytes);
        tma_load_tile<DP>(s.k[stage], &tm_k, &s.full[stage], k0, kvh, b);
        tma_load_tile<DP>(s.v[stage], &tm_v, &s.full[stage], k0, kvh, b);
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup: this thread's rows are row0 and row0 + 8 of the tile,
  // its columns col0 and col0 + 1 of each 8-column group
  const int row0 = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int q_pos[2] = {q0 + row0 + p.q_offset, q0 + row0 + 8 + p.q_offset};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&s.q_full, 0);
  int stage = 0, phase = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    if (!tile_has_valid_key(valid, k0, p.Sk)) continue;
    mbar_wait(&s.full[stage], phase);

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, desc_k_major<DP>(s.q, kk), desc_k_major<DP>(s.k[stage], kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask (selects, no branches), then the online softmax on the fragments
    const uint32_t bad = invalid_key_bits(valid, k0, col0, p.Sk);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + col0 + e;
        const bool invalid = (bad >> (2 * j + e)) & 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = sc[4 * j + 2 * r + e] * p.scale;
          x = in_window(p.causal, p.window, q_pos[r], kj) ? x : kNegInf;
          x = invalid ? x + kNegInf : x;
          x = kj < p.Sk ? x : -INFINITY;  // past the keys: contributes nothing
          sc[4 * j + 2 * r + e] = x;
          mt[r] = fmaxf(mt[r], x);
        }
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * r + e];
          x = m[r] == -INFINITY ? 0.f : exp2_approx((x - m[r]) * kLog2e);
          rs[r] += x;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V, P in bf16 from registers
    uint32_t a[4][4];
    acc_to_a(sc, a);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<DP>(o, a[kk], s.v[stage], kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&s.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= p.Sq) continue;
    const bool alive = m[r] > 0.5f * kNegInf;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col0;
      if (c < p.D) {
        const float x0 = alive ? o[4 * j + 2 * r] * inv : 0.f;
        const float x1 = alive ? o[4 * j + 2 * r + 1] * inv : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(O + qi * p.o_ss + c) = __floats2bfloat162_rn(x0, x1);
      }
    }
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[((int64_t)b * p.H + h) * p.Sq + qi] = row_lse(m[r], l[r]);
  }
}

template <int DP>
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  using hopper_host::bf16_tile_map;
  if (!bf16_tile_map(&tm_q, p.q, batch, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, DP) ||
      !bf16_tile_map(&tm_k, p.k, batch, p.Sk, p.KVH, p.D, p.k_sb, p.k_ss, p.k_sh, DP) ||
      !bf16_tile_map(&tm_v, p.v, batch, p.Sk, p.KVH, p.D, p.v_sb, p.v_ss, p.v_sh, DP))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(FwdSmem<DP>);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  fwd_bf16_kernel<DP><<<grid, kTcThreads, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
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

template <int kCols>
int launch_f32_cols(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);  // 214,272 bytes at D = 256
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  flash_fwd_kernel<float, kCols><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  return p.D <= 128 ? launch_f32_cols<8>(p, batch, stream) : launch_f32_cols<16>(p, batch, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel; head_dim
// a multiple of 8, 16-byte aligned bases and strides). lse: [B, H, Sq] fp32,
// or null. Returns a cudaError_t (0 on success).
int cambrian_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* key_valid, void* o, float* lse,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int batch, int heads, int kv_heads, int s_q, int s_k, int head_dim,
    float scale, int causal, int window, int q_offset, void* stream) {
  if (head_dim < 1 || head_dim > kMaxD || kv_heads < 1 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, key_valid, o, lse,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
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
