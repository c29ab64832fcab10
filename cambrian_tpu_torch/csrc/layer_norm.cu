// LayerNorm over the last axis for Hopper (sm_90a), with a plain C interface
// that cambrian_tpu_torch/ops/norms.py loads through ctypes. Kernel K6 of the
// port: replaces the TPU kernel _ln_kernel of cambrian_tpu/ops/norms.py
// (reached from fused_layer_norm through _ln_pallas).
//
// out[r, :] = (x[r, :] - mean) * rsqrt(var + eps) * w + b, with mean and
// var = mean((x - mean)^2) in fp32 (two passes, as the TPU kernel), the
// affine in fp32, and one cast to x's dtype (bf16 or fp32). w and b are fp32.
// Any width C is taken: the TPU kernel's C % 128 rule was a tiling rule of
// its vector registers.
//
// What bounds it on the card: the bytes. It reads x once from device memory
// and writes the output once; its ~8 fp32 operations an element are far
// below the card's operations-per-byte line. One warp owns a row: its lanes
// stride over the row (neighbouring lanes on neighbouring elements, so the
// loads coalesce), the sums are warp shuffles, and no shared memory or
// second launch is needed. The second and third passes over the row read it
// again, from L1/L2 rather than device memory (a row is at most a few KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ out, int rows, int cols,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* orow = out + row * cols;
  const float n = (float)cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / n;
  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss = fmaf(d, d, ss);
  }
  const float inv = rsqrtf(warp_sum(ss) / n + eps);
  for (int c = lane; c < cols; c += 32) {
    const float y = (to_f32(xr[c]) - mean) * inv;
    store_as(orow + c, fmaf(y, __ldg(w + c), __ldg(b + c)));
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out [rows, cols] contiguous, w and
// b fp32 [cols]. Returns a cudaError_t (0 on success).
int cambrian_layer_norm(int dtype, const void* x, const float* w, const float* b, void* out,
                        int rows, int cols, float eps, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    layer_norm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), w, b, static_cast<float*>(out), rows, cols, eps);
  } else if (dtype == 1) {
    layer_norm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(out), rows,
        cols, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
