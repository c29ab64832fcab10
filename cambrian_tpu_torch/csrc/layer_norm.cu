// LayerNorm over the last axis for Hopper (sm_90a), with a plain C interface
// that cambrian_tpu_torch/ops/norms.py loads through ctypes. Kernel K6 of the
// port: replaces the TPU kernel _ln_kernel of cambrian_tpu/ops/norms.py
// (reached from fused_layer_norm through _ln_pallas).
//
// out[r, :] = (x[r, :] - mean) * rsqrt(var + eps) * w + b, with the TPU
// kernel's order of operations: the fp32 mean, then var = the fp32 mean of
// (x - mean)^2 (not a one-pass or Welford variance), rsqrt, the affine in
// fp32, one cast to x's dtype (bf16 or fp32). w and b are fp32.
//
// What bounds it on the card: the bytes at the ConvNeXt sites (16-50 MB a
// call at 4,096-65,536 rows), and latency at the 576-1,024-row ViT and SVA
// sites, where the bytes take under a microsecond. Two kernel functions;
// _ln_plan in ops/norms.py picks one before the launch:
//
//   - layer_norm_vec_kernel<T, LANES, VPL> takes every row whose width is a
//     whole number of 16-byte chunks (C % 8 == 0 in bf16, C % 4 == 0 in
//     fp32) at 16-byte-aligned x, w, b and out, up to 32 x 16 chunks (C 4096
//     bf16, 2048 fp32). A sub-warp of LANES lanes (4, 8, 16 or 32) owns a
//     row (a whole warp from 64 chunks, C 512 bf16, up: a longer share a
//     lane is latency the small sites pay in full), so a warp carries
//     32 / LANES rows at a time; each lane loads its
//     VPL chunks (chunk j * LANES + lane, so the sub-warp's loads are
//     contiguous) with 16-byte loads into registers, and everything after
//     that reads registers: the lane's sum, in chunk and element order, then
//     a butterfly of shuffles inside the sub-warp (every lane ends with the
//     same bits), the same again for the centred squares, then the
//     normalised row goes out with 16-byte stores. One pass over device
//     memory. A row of fewer chunks than LANES * VPL leaves the last slots
//     empty (predicated off). w and b (fp32) are read as float4; where a
//     lane's share is at most 32 floats each, they are loaded once a warp and
//     kept in registers across the warp's rows, else a block stages them in
//     shared memory by cp.async, sent beside the first row's loads (read
//     for every row from L1, they came after the row's sums, on its
//     critical path, and cost four times the row's own bf16 bytes). The
//     grid fills the card: at under ~2,000 rows, blocks of
//     1-2 warps and one row group a warp, so a 576-row site spreads over
//     every SM; above, blocks of 4 warps, as many as the SMs hold at once,
//     striding over the rows.
//   - layer_norm_kernel<T> takes the rest (a C that is not a whole number
//     of chunks, an unaligned base, wider rows): one warp a row, lanes
//     strided over the row element by element, three walks over it (mean,
//     variance, normalise; the second and third from L1/L2).
//
// The C entries refuse (invalid argument) any launch shape the kernel
// cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVecMaxThreads = 4 * 32;   // blocks of the vector kernel: 1, 2 or 4 warps

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

// -- the vector route -----------------------------------------------------------

// 16 bytes that are read once: past L1, not kept there
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Element e of a 16-byte chunk as fp32: 8 bf16 (exact: the bits moved up)
// or 4 fp32.
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& v, int e) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 2) {
    const uint32_t wd = words[e / 2];
    return __uint_as_float(e % 2 == 0 ? wd << 16 : wd & 0xFFFF0000u);
  } else {
    return __uint_as_float(words[e]);
  }
}

// Elements 2i, 2i + 1 as one 32-bit word of the output type's chunk.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int LANES>
__device__ __forceinline__ float subwarp_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// w and b are held in registers across a warp's rows where a lane's share
// of each is at most 32 floats (under 32 in a sub-warp: at 32 the sub-warp
// shapes used stack); otherwise a block stages them in shared memory
// (cp.async, sent with the first row's loads, so their latency is off the
// row's critical path) and every row reads them there. At C 1024 (32
// floats a lane) registers were ~1 us a call faster than staging.
__host__ __device__ constexpr bool vec_keeps_wb(int elems_a_chunk, int lanes, int vpl) {
  return vpl * elems_a_chunk < 32 || (vpl * elems_a_chunk == 32 && lanes == 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// The sub-warp's row `row` (zero where it is past the rows or a slot past
// the row): chunk j * LANES + li of the lane.
template <typename T, int LANES, int VPL>
__device__ __forceinline__ void vec_load_row(const T* x, int64_t row, bool live, int cols,
                                             int chunks, int li, uint4 (&v)[VPL]) {
  constexpr int kE = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * LANES + li;
    v[j] = live && c < chunks ? ld_stream(x + row * cols + (int64_t)c * kE)
                              : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int LANES, int VPL>
__global__ void __launch_bounds__(kVecMaxThreads)
    layer_norm_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ out, int rows, int cols,
                          float eps) {
  constexpr int kE = 16 / sizeof(T);       // elements a chunk
  constexpr int kRows = 32 / LANES;        // rows a warp carries at a time
  constexpr int kW4 = kE / 4;              // float4 of w (and of b) a chunk
  constexpr bool kKeepWB = vec_keeps_wb(kE, LANES, VPL);
  extern __shared__ __align__(16) float4 wb_smem[];  // [w | b] of the row, when staged
  const int lane = threadIdx.x & 31, li = lane % LANES, sub = lane / LANES;
  const int chunks = cols / kE;
  const int groups = (rows + kRows - 1) / kRows;
  const int warps = gridDim.x * (blockDim.x / 32);
  const float n = (float)cols;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);

  if constexpr (!kKeepWB) {
    for (int i = threadIdx.x; i < cols / 4; i += blockDim.x) {
      cp_async16(wb_smem + i, w4 + i);
      cp_async16(wb_smem + cols / 4 + i, b4 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int g = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  uint4 v[VPL];
  vec_load_row<T, LANES, VPL>(x, (int64_t)g * kRows + sub, g < groups && g * kRows + sub < rows,
                              cols, chunks, li, v);
  float4 wr[kKeepWB ? VPL * kW4 : 1], br[kKeepWB ? VPL * kW4 : 1];
  if constexpr (kKeepWB) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * LANES + li;
#pragma unroll
      for (int q = 0; q < kW4; ++q) {
        wr[j * kW4 + q] = c < chunks ? __ldg(w4 + c * kW4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        br[j * kW4 + q] = c < chunks ? __ldg(b4 + c * kW4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  for (bool first = true; g < groups; g += warps, first = false) {
    const int64_t row = (int64_t)g * kRows + sub;
    const bool live = row < rows;
    if (!first) vec_load_row<T, LANES, VPL>(x, row, live, cols, chunks, li, v);
    // the lane's sum in chunk and element order (empty slots hold zeros),
    // then the sub-warp's
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < kE; ++e) s += chunk_elem<T>(v[j], e);
    const float mean = subwarp_sum<LANES>(s) / n;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (j * LANES + li < chunks) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float d = chunk_elem<T>(v[j], e) - mean;
          ss = fmaf(d, d, ss);
        }
      }
    }
    const float inv = rsqrtf(subwarp_sum<LANES>(ss) / n + eps);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * LANES + li;
      if (c >= chunks) continue;
      float wv[kE], bv[kE];
#pragma unroll
      for (int q = 0; q < kW4; ++q) {
        float4 wq, bq;
        if constexpr (kKeepWB) {
          wq = wr[j * kW4 + q];
          bq = br[j * kW4 + q];
        } else {
          wq = wb_smem[c * kW4 + q];
          bq = wb_smem[cols / 4 + c * kW4 + q];
        }
        wv[4 * q] = wq.x, wv[4 * q + 1] = wq.y, wv[4 * q + 2] = wq.z, wv[4 * q + 3] = wq.w;
        bv[4 * q] = bq.x, bv[4 * q + 1] = bq.y, bv[4 * q + 2] = bq.z, bv[4 * q + 3] = bq.w;
      }
      float o[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        o[e] = fmaf((chunk_elem<T>(v[j], e) - mean) * inv, wv[e], bv[e]);
      uint4 r;
      if constexpr (sizeof(T) == 2) {
        r = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                       pack_bf16(o[6], o[7]));
      } else {
        r = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                       __float_as_uint(o[3]));
      }
      *reinterpret_cast<uint4*>(out + row * cols + (int64_t)c * kE) = r;
    }
  }
}

// The instantiated shapes, (lanes a row, chunks a lane): those _ln_plan can
// give (norms.py LN_INSTANCES, which must list the same pairs), in order of
// lanes, then chunks.
#define LN_VEC_INSTANCES(X)                                                            \
  X(4, 1) X(4, 3) X(4, 5) X(4, 9) X(8, 1) X(8, 3) X(8, 5) X(16, 1) X(16, 3) X(32, 1) \
  X(32, 2) X(32, 3) X(32, 4) X(32, 5) X(32, 6) X(32, 8) X(32, 9) X(32, 12) X(32, 16)

template <typename T>
const void* vec_kernel_of(int lanes, int vpl) {
#define LN_VEC_CASE(L, V) \
  if (lanes == L && vpl == V) return (const void*)layer_norm_vec_kernel<T, L, V>;
  LN_VEC_INSTANCES(LN_VEC_CASE)
#undef LN_VEC_CASE
  return nullptr;
}

// the fewest chunks a lane of `lanes` takes for a row of `chunks`: the
// smallest instantiated count of those lanes that covers the row
int vec_chunks_a_lane(int chunks, int lanes) {
#define LN_VEC_PAIR(L, V) {L, V},
  constexpr int kInstances[][2] = {LN_VEC_INSTANCES(LN_VEC_PAIR)};
#undef LN_VEC_PAIR
  for (const auto& lv : kInstances)
    if (lv[0] == lanes && lv[1] * lanes >= chunks) return lv[1];
  return 0;
}

const void* vec_kernel(int dtype, int lanes, int vpl) {
  if (dtype == 0) return vec_kernel_of<float>(lanes, vpl);
  if (dtype == 1) return vec_kernel_of<__nv_bfloat16>(lanes, vpl);
  return nullptr;
}

// Shared memory of a launch: w and b of `cols` elements where the kernel
// stages them, else none.
size_t vec_smem_bytes(int dtype, int lanes, int vpl, int cols) {
  return vec_keeps_wb(dtype == 0 ? 4 : 8, lanes, vpl) ? 0 : (size_t)cols * 8;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out [rows, cols] contiguous, w and
// b fp32 [cols]. The scalar kernel (layer_norm_kernel). Returns a
// cudaError_t (0 on success).
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

// How many blocks of layer_norm_vec_kernel<dtype, lanes, vpl> of `warps`
// warps one SM holds at once, into *blocks.
// (The shared memory counted is that of the widest row the shape takes,
// lanes x vpl chunks.)
int cambrian_layer_norm_vec_occupancy(int dtype, int lanes, int vpl, int warps, int* blocks) {
  const void* fn = vec_kernel(dtype, lanes, vpl);
  if (fn == nullptr || warps < 1 || warps * 32 > kVecMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = vec_smem_bytes(dtype, lanes, vpl, lanes * vpl * (dtype == 0 ? 4 : 8));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, warps * 32, smem);
}

// The vector kernel (layer_norm_vec_kernel) under an LnPlan of ops/norms.py:
// `lanes` lanes a row holding `vpl` 16-byte chunks each, blocks of `warps`
// warps. Refuses, launching nothing, operands or a shape the kernel cannot
// take: a width of other than whole chunks, a base off 16 bytes, a vpl other
// than the fewest instantiated chunks a lane that cover the row, a block
// without a row group. How many blocks the card holds at once is the
// plan's rule (it asks cambrian_layer_norm_vec_occupancy, once a shape):
// the kernel strides over the row groups, so any grid is correct.
int cambrian_layer_norm_vec(int dtype, const void* x, const float* w, const float* b, void* out,
                            int rows, int cols, float eps, int lanes, int vpl, int warps,
                            int blocks, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const void* fn = vec_kernel(dtype, lanes, vpl);
  const int per_chunk = dtype == 0 ? 4 : 8;
  if (fn == nullptr || rows < 1 || cols < per_chunk || cols % per_chunk != 0 || misaligned(x) ||
      misaligned(w) || misaligned(b) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  const int chunks = cols / per_chunk;
  if (vpl != vec_chunks_a_lane(chunks, lanes)) return (int)cudaErrorInvalidValue;
  const int groups = (rows + 32 / lanes - 1) / (32 / lanes);
  if (warps < 1 || warps * 32 > kVecMaxThreads || blocks < 1 ||
      (long)(blocks - 1) * warps >= groups)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&w, (void*)&b, (void*)&out, (void*)&rows, (void*)&cols,
                  (void*)&eps};
  const size_t smem = vec_smem_bytes(dtype, lanes, vpl, cols);
  const cudaError_t err = cudaLaunchKernel(fn, dim3(blocks), dim3(warps * 32), args, smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
