// Depthwise 7x7 convolution in the NHWC layout for Hopper (sm_90a), with a
// plain C interface that cambrian_tpu_torch/ops/dwconv.py loads through
// ctypes. Kernel K7 of the port: replaces the TPU kernel _kernel of
// cambrian_tpu/ops/dwconv.py (reached from depthwise_conv7x7 through
// _dwconv_fwd_impl).
//
// out[b, h, w, c] = bias[c] + sum_{dy, dx} x[b, h + dy - 3, w + dx - 3, c] * wt[dy, dx, c]
// with SAME padding 3, stride 1, zero outside the map. x and out are bf16 or
// fp32, wt [7, 7, C] and bias [C] fp32. The 49 taps accumulate in fp32 in
// the TPU kernel's order (dy outer, dx inner), the bias is added in fp32,
// and the result is cast once.
//
// What bounds it on the card: 98 fp32 operations an output element on the
// CUDA cores against 4 bytes (bf16 in and out), so the bytes bound it at
// 3.35 TB/s, but only if every input element is read from device memory
// about once. A block owns an 8-row x 16-column x 32-channel output tile. It
// stages the halo'd (8+6) x (16+6) x 32 input tile in shared memory as fp32
// (39.4 KB), with zeros past the edges instead of a padded copy in device
// memory. The 32 threads of a warp take 32 neighbouring channels (C is the
// fastest axis), so global reads coalesce and shared-memory
// reads are free of bank conflicts. Each thread keeps its channel's 49
// weights and one output row of 16 accumulators in registers and slides
// along the staged row: each staged value is read once per kernel row and
// feeds up to 7 outputs. H, W and C need not divide the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 7;
constexpr int kPad = 3;
constexpr int kTH = 8;                  // output rows per block (one per warp)
constexpr int kTW = 16;                 // output columns per block (per thread)
constexpr int kTC = 32;                 // channels per block (one per lane)
constexpr int kSH = kTH + kK - 1;       // staged rows
constexpr int kSW = kTW + kK - 1;       // staged columns
constexpr int kThreads = kTH * kTC;     // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dwconv7x7_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C) {
  __shared__ float tile[kSH][kSW][kTC];
  const int c_tiles = (C + kTC - 1) / kTC;
  const int b = blockIdx.z / c_tiles;
  const int c0 = (blockIdx.z % c_tiles) * kTC;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int tid = threadIdx.x, lc = tid % kTC, r = tid / kTC;
  const T* xb = x + (int64_t)b * H * W * C;

  for (int i = tid; i < kSH * kSW * kTC; i += kThreads) {
    const int cc = i % kTC, rest = i / kTC;
    const int sx = rest % kSW, sy = rest / kSW;
    const int hh = h0 + sy - kPad, ww = w0 + sx - kPad, c = c0 + cc;
    float v = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < C)
      v = to_f32(xb[((int64_t)hh * W + ww) * C + c]);
    tile[sy][sx][cc] = v;
  }
  __syncthreads();

  const int c = c0 + lc, h = h0 + r;
  if (c >= C || h >= H) return;
  float wr[kK * kK];
#pragma unroll
  for (int i = 0; i < kK * kK; ++i) wr[i] = __ldg(wt + (int64_t)i * C + c);
  float acc[kTW];
#pragma unroll
  for (int o = 0; o < kTW; ++o) acc[o] = 0.f;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
    for (int j = 0; j < kSW; ++j) {
      const float v = tile[r + dy][j][lc];
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        const int o = j - dx;  // the output column that reads staged column j at tap dx
        if (o >= 0 && o < kTW) acc[o] = fmaf(v, wr[dy * kK + dx], acc[o]);
      }
    }
  }
  const float bc = __ldg(bias + c);
  T* orow = out + (((int64_t)b * H + h) * W + w0) * C + c;
#pragma unroll
  for (int o = 0; o < kTW; ++o) {
    if (w0 + o < W) store_as(orow + (int64_t)o * C, acc[o] + bc);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out [B, H, W, C] contiguous, wt
// [7, 7, C] and bias [C] fp32 contiguous. Returns a cudaError_t.
int cambrian_dwconv7x7(int dtype, const void* x, const float* wt, const float* bias, void* out,
                       int B, int H, int W, int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int c_tiles = (C + kTC - 1) / kTC;
  if ((int64_t)B * c_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * c_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dwconv7x7_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), wt, bias, static_cast<float*>(out), H, W, C);
  } else if (dtype == 1) {
    dwconv7x7_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wt, bias, static_cast<__nv_bfloat16*>(out), H,
        W, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
