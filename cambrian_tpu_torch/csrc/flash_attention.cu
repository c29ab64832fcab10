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
//
// Design. The TPU kernel keeps the whole K/V stripe of a (batch, head) in
// VMEM and does one row-complete softmax. A Hopper block has at most 227 KB
// of shared memory, so here one block owns a 64-row q tile of one
// (batch, head), walks the keys in 64-row K/V tiles staged in shared memory
// (converted to fp32 on load), and keeps an online softmax: a running row
// maximum and sum in shared memory and the [64, D] output accumulator in
// registers, rescaled when the maximum moves. Causal tiles past the q tile's
// last position, and sliding-window tiles before its first, are skipped.
//
// What bounds it on the card: the two products run on the CUDA cores in fp32
// (SIMT FMAs fed from shared memory), not on the tensor cores, so the kernel
// is bound by FMA issue and shared-memory bandwidth, far below the bf16
// tensor-core rate. That keeps fp32 inputs exact to fp32 rounding. Moving the
// bf16 products to wgmma with TMA-fed K/V tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 grid: each thread owns 4 q rows
constexpr int kMaxD = 128;
constexpr int kMaxCols = kMaxD / 16;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // NEG_INF of the JAX package

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

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kBlockQ * d            // Q tile
                                  + kBlockK * (d + 1)     // K tile, padded rows
                                  + kBlockK * d           // V tile
                                  + kBlockQ * (kBlockK + 1)  // logits / probs
                                  + 3 * kBlockQ);         // max, sum, rescale
}

template <typename T>
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

  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + kBlockQ, p.Sq) - 1 + p.q_offset;
    k_end = min(k_end, last_q + 1);
  }
  if (p.window > 0) {
    k_begin = max(0, q0 + p.q_offset - p.window + 1) / kBlockK * kBlockK;
  }

  float acc[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[r][j] = 0.f;

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
      for (int j = 0; j < kMaxCols; ++j) acc[r][j] *= alpha;
    }
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty * 4 + r) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
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
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store_as(O + qi * p.o_ss + c, alive ? acc[r][j] * inv : 0.f);
    }
  }
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, batch * p.H);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int cambrian_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* key_valid, void* o,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int batch, int heads, int kv_heads, int s_q, int s_k, int head_dim,
    float scale, int causal, int window, int q_offset, void* stream) {
  if (head_dim < 1 || head_dim > kMaxD || kv_heads < 1 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, key_valid, o,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
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
