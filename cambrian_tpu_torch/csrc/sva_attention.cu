// SVA windowed cross-attention for Hopper (sm_90a), with a plain C interface
// that cambrian_tpu_torch/ops/sva_attention.py loads through ctypes. Kernel K5
// of the port: replaces the TPU kernel _kernel of
// cambrian_tpu/ops/sva_attention.py (reached from
// fused_windowed_cross_attention through _fused_impl).
//
// Each (batch b, query q, head h) attends over its own window of W keys:
//   logit[w] = mask[b, q, (h,) w] ? scale * sum_d q[b,q,h,d] k[b,q,w,h,d] : NEG_INF
//   p = exp(logit - max) / sum(exp(logit - max))          (fp32)
//   out[b,q,h,:] = sum_w p[w] v[b,q,w,h,:]                (fp32, cast once)
// The probabilities stay fp32 through the PV product, as in the TPU kernel
// (the einsum path of ops/attention.py rounds them to the input dtype
// first). A fully masked window has every logit at the finite NEG_INF, so it
// gets uniform weights: the mean of V.
//
// What bounds it on the card: the bytes. Each (q, h) reads its own W keys
// and values once (no reuse across queries), and its ~4 W D operations are
// CUDA-core work on a [D] x [W, D] product too small for the tensor cores.
// One warp owns a (b, q, h): the lanes hold q and the output along D (D <= 128,
// 4 elements a lane), each key's dot product is one coalesced read of the
// key row and a warp-shuffle sum, and lane w % 32 keeps logit w in a register
// (W <= 64). Masks are read through strides, so [B, Q, W] and [B, Q, H, W]
// masks and None take the same path; q, k, v and out are read through their
// strides, with a unit stride along D.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWindow = 64;
constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -0.7f * FLT_MAX;  // ops/attention.py NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Args {
  const void* q;            // [B, Q, H, D]
  const void* k;            // [B, Q, W, H, D]
  const void* v;            // [B, Q, W, H, D]
  const uint8_t* mask;      // bool, or null for no mask
  void* out;                // [B, Q, H, D]
  int64_t q_s[3];           // strides of b, q, h (elements)
  int64_t k_s[4];           // b, q, w, h
  int64_t v_s[4];
  int64_t m_s[4];           // b, q, h (0 for a [B, Q, W] mask), w
  int64_t o_s[3];
  int B, Q, H, W, D;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) sva_attention_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= (int64_t)a.B * a.Q * a.H) return;
  const int h = (int)(item % a.H);
  const int64_t bq = item / a.H;
  const int qi = (int)(bq % a.Q);
  const int b = (int)(bq / a.Q);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_s[0] + qi * a.q_s[1] + h * a.q_s[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.k_s[0] + qi * a.k_s[1] + h * a.k_s[3];
  const T* vp = static_cast<const T*>(a.v) + b * a.v_s[0] + qi * a.v_s[1] + h * a.v_s[3];
  const uint8_t* mp =
      a.mask == nullptr ? nullptr : a.mask + b * a.m_s[0] + qi * a.m_s[1] + h * a.m_s[2];

  constexpr int kPer = kMaxHeadDim / 32;
  float qv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < a.D ? to_f32(qp[d]) : 0.f;
  }

  // logits of keys lane and lane + 32
  float s0 = kNegInf, s1 = kNegInf;
  for (int w = 0; w < a.W; ++w) {
    const T* kw = kp + w * a.k_s[2];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) part = fmaf(qv[i], to_f32(kw[d]), part);
    }
    float logit = warp_sum(part) * a.scale;
    if (mp != nullptr && !mp[w * a.m_s[3]]) logit = kNegInf;
    if (w == lane) s0 = logit;
    if (w == lane + 32) s1 = logit;
  }
  const float mx = warp_max(fmaxf(s0, s1));
  // keys past W are not in the window: they take no weight
  float p0 = lane < a.W ? expf(s0 - mx) : 0.f;
  float p1 = lane + 32 < a.W ? expf(s1 - mx) : 0.f;
  const float sum = warp_sum(p0 + p1);
  p0 = p0 / sum;
  p1 = p1 / sum;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int w = 0; w < a.W; ++w) {
    const float pw = __shfl_sync(0xffffffffu, w < 32 ? p0 : p1, w & 31);
    const T* vw = vp + w * a.v_s[2];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) acc[i] = fmaf(pw, to_f32(vw[d]), acc[i]);
    }
  }
  T* op = static_cast<T*>(a.out) + b * a.o_s[0] + qi * a.o_s[1] + h * a.o_s[2];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < a.D) store_as(op + d, acc[i]);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides in
// elements: q_s/o_s (b, q, h), k_s/v_s (b, q, w, h), m_s (b, q, h, w); the
// last axis of q, k, v and out has a unit stride. mask may be null. Returns
// a cudaError_t (0 on success).
int cambrian_sva_attention(int dtype, const void* q, const void* k, const void* v,
                           const uint8_t* mask, void* out, const int64_t* q_s,
                           const int64_t* k_s, const int64_t* v_s, const int64_t* m_s,
                           const int64_t* o_s, int B, int Q, int H, int W, int D, float scale,
                           void* stream) {
  if (B < 1 || Q < 1 || H < 1 || W < 1 || W > kMaxWindow || D < 1 || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, mask, out, {}, {}, {}, {}, {}, B, Q, H, W, D, scale};
  for (int i = 0; i < 3; ++i) {
    a.q_s[i] = q_s[i];
    a.o_s[i] = o_s[i];
  }
  for (int i = 0; i < 4; ++i) {
    a.k_s[i] = k_s[i];
    a.v_s[i] = v_s[i];
    a.m_s[i] = mask == nullptr ? 0 : m_s[i];
  }
  const int64_t items = (int64_t)B * Q * H;
  const dim3 grid((unsigned)((items + kWarps - 1) / kWarps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sva_attention_kernel<float><<<grid, kThreads, 0, st>>>(a);
  } else if (dtype == 1) {
    sva_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
