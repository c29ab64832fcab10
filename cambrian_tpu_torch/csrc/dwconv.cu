// Depthwise 7x7 convolution in the NHWC layout for Hopper (sm_90a), with a
// plain C interface that cambrian_tpu_torch/ops/dwconv.py loads through
// ctypes. Kernel K7 of the port: replaces the TPU kernel _kernel of
// cambrian_tpu/ops/dwconv.py (reached from depthwise_conv7x7 through
// _dwconv_fwd_impl).
//
// out[b, h, w, c] = bias[c] + sum_{dy, dx} x[b, h + dy - 3, w + dx - 3, c] * wt[dy, dx, c]
// with SAME padding 3, stride 1, zero outside the map. x and out are bf16 or
// fp32; wt [7, 7, C] and bias [C] are bf16 or fp32 in any element strides
// (the ConvNeXt weight [C, 1, 7, 7] read in place as [7, 7, C] has a channel
// stride of 49), read as they are, without a copy. The 49 taps accumulate in
// fp32 in the TPU kernel's order (dy outer, dx inner), the bias is added in
// fp32, and the result is cast once.
//
// What bounds it on the card: 49 fp32 multiply-adds and the bias an output
// element on the CUDA cores (99 operations; 9.3 us at 67 TFLOP/s for the 6.3
// M elements of ConvNeXt-XXL's 64 x 64 x 1536 stage) against 4 bytes in and
// out in bf16 (7.5 us at 3.35 TB/s): the operations, with the bytes close
// behind. So the loop must be almost all FFMA, and the input must reach
// shared memory without costing the CUDA cores instructions.
//
// dwconv7x7_tma_kernel<T, R, CW>, the route for every operand TMA can map
// (x contiguous, its base and a position's C channels whole 16-byte units):
// - One 4-D tensor map over x (dims C, W, H, B). A tile is 32 channels x
//   TH output rows x TW output columns; its input is one TMA box of 32 x
//   (TW + 6) x (TH + 6) x 1 at (c0, w0 - 3, h0 - 3, b). TMA fills every
//   coordinate outside x with zeros, negative ones included: SAME padding
//   with no padded copy, no index decode and no bounds test in the kernel.
// - A persistent grid (the plan's blocks, as many as the SMs hold at once):
//   block k takes the contiguous range [k T / G, (k + 1) T / G) of the T
//   tiles, ordered channel slice, batch, tile row, tile column. A block's
//   slice rarely changes along its range, so its threads stage the slice's
//   49 x 32 weights (and biases) once per slice, not once per tile.
// - A ring of 2-4 shared-memory stages (the plan gives 2 or 3), each with a
//   full and an empty mbarrier. Thread 0 asks for the first box before
//   anything else, and for it alone (every block's first box then comes
//   back first); the rest of the ring fills once it has landed, and from
//   then on thread 0 keeps the next boxes in flight while the block
//   computes; a warp releases a stage once it has read it.
// - Each thread owns one channel (its lane: a warp reads 32 neighbouring
//   channels of one position, 64 or 128 contiguous bytes, free of bank
//   conflicts in the unswizzled box) and a register block of R output rows
//   x CW output columns (4 x 4: a larger block's fully unrolled tile loop
//   outgrows the instruction cache and issues slower, scripts/dwconv_sweep.py).
//   It walks the R + 6 staged rows and CW + 6 staged columns in order; each
//   value it reads feeds every accumulator of its block that takes it (up to
//   7 along dx, and R along dy), so an accumulator still receives its taps
//   dy outer, dx inner. bf16 widens to fp32 on the read (a 16-bit shift,
//   exact).
// - Each warp writes its R x CW x 32 outputs into a box of its own in
//   shared memory and stores it with one TMA store over a second tensor map
//   (the output's); TMA drops what lies outside the tensor, so the epilogue
//   is an add, a convert and a shared-memory store an output, with no
//   address arithmetic and no bounds tests.
//
// dwconv7x7_kernel<T>, the first port's kernel, takes the rest (x not
// contiguous, a base off 16 bytes, C * sizeof(T) off 16 bytes): an 8-row x
// 16-column x 32-channel output tile a block, its halo'd input staged in
// shared memory as fp32 by the threads themselves, with zeros past the
// edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kK = 7;
constexpr int kTaps = kK * kK;
constexpr int kPad = 3;
constexpr int kHalo = kK - 1;
constexpr int kTC = 32;                 // channels a tile (one per lane)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The weights, the bias and the output: wt [7, 7, C] at element strides
// w_s (dy, dx, c) and bias [C] at b_s, each fp32 or bf16 (w_bf16, b_bf16);
// out [B, H, W, C] contiguous in x's dtype.
struct Params {
  const void* w;
  const void* bias;
  void* out;
  int64_t w_s[3];
  int64_t b_s;
  int w_bf16, b_bf16;
  int B, H, W, C;
};

__device__ __forceinline__ int64_t tap_offset(const Params& p, int tap, int c) {
  return tap / kK * p.w_s[0] + tap % kK * p.w_s[1] + (int64_t)c * p.w_s[2];
}

// N weights of W (float or __nv_bfloat16) as fp32, weight (tap[u], c[u]) or
// 0 where ok[u] is false, and bias[bc] of B (0 unless b_ok). Every load is
// issued before any is widened (no branch between them), so a thread waits
// for its loads once, not N + 1 times.
template <typename W, typename B, int N>
__device__ __forceinline__ void load_params(const Params& p, const int (&tap)[N],
                                            const int (&c)[N], const bool (&ok)[N],
                                            float (&out)[N], int bc, bool b_ok, float& b_out) {
  const W* w = static_cast<const W*>(p.w);
  const B braw = static_cast<const B*>(p.bias)[b_ok ? (int64_t)bc * p.b_s : 0];
  W raw[N];
#pragma unroll
  for (int u = 0; u < N; ++u) raw[u] = w[ok[u] ? tap_offset(p, tap[u], c[u]) : 0];
#pragma unroll
  for (int u = 0; u < N; ++u) out[u] = ok[u] ? to_f32(raw[u]) : 0.f;
  b_out = b_ok ? to_f32(braw) : 0.f;
}

template <int N>
__device__ __forceinline__ void load_params(const Params& p, const int (&tap)[N],
                                            const int (&c)[N], const bool (&ok)[N],
                                            float (&out)[N], int bc, bool b_ok, float& b_out) {
  using bf16 = __nv_bfloat16;
  if (p.w_bf16 && p.b_bf16)
    load_params<bf16, bf16>(p, tap, c, ok, out, bc, b_ok, b_out);
  else if (p.w_bf16)
    load_params<bf16, float>(p, tap, c, ok, out, bc, b_ok, b_out);
  else if (p.b_bf16)
    load_params<float, bf16>(p, tap, c, ok, out, bc, b_ok, b_out);
  else
    load_params<float, float>(p, tap, c, ok, out, bc, b_ok, b_out);
}

// ---------------------------------------------------------------------------
// dwconv7x7_tma_kernel
// ---------------------------------------------------------------------------

constexpr int kMinStages = 2;           // a box in flight while the block computes
constexpr int kMaxStages = 4;
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 8;            // 256 threads; two blocks an SM keep <= 128 registers
// a thread's share of a slice's weights in a block of at least kMinWarps warps
constexpr int kShare = (kTaps * kTC + kMinWarps * 32 - 1) / (kMinWarps * 32);

// A launch's tiling, as the plan (_dw_plan in ops/dwconv.py) gives it.
struct Tiles {
  int warps_h, warps_w;   // warps along a tile's rows and columns
  int tile_h, tile_w;     // output rows and columns a tile: R warps_h, CW warps_w
  int tiles_h, tiles_w;   // tiles along H and W
  int tiles;              // slices of 32 channels x B x tiles_h x tiles_w
  int stages;
  uint32_t stage_bytes;   // a box, rounded up to 128 bytes
  uint32_t box_bytes;     // 32 x (tile_w + 6) x (tile_h + 6) elements
};

// The head of shared memory; each warp's output box and the stages follow it.
struct alignas(128) Head {
  uint64_t full[kMaxStages];    // a stage's box has landed (TMA's transaction count)
  uint64_t empty[kMaxStages];   // every warp has read the stage
  float w[kTaps][kTC];          // the slice's weights, fp32
};

template <typename T, int R, int CW>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    dwconv7x7_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_out, Params p, Tiles g) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Head& hd = *reinterpret_cast<Head*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  // the warp's output box: R x CW positions of 32 channels, as TMA stores it
  T* obox = reinterpret_cast<T*>(smem_raw + sizeof(Head)) + warp * (R * CW * kTC);
  uint8_t* stages = smem_raw + sizeof(Head) + n_warps * (R * CW * kTC * sizeof(T));
  const int wr = warp / g.warps_w, wc = warp % g.warps_w;
  const int t_begin = (int)((int64_t)blockIdx.x * g.tiles / gridDim.x);
  const int n = (int)((int64_t)(blockIdx.x + 1) * g.tiles / gridDim.x) - t_begin;
  const int per_slice = p.B * g.tiles_h * g.tiles_w;

  // A tile's position, counted along the block's range in the walk's order
  // (column, row, batch, slice), so the loops divide by nothing.
  struct Pos {
    int slice, b, ty, tx;
  };
  const auto advance = [&](Pos& q) {
    if (++q.tx == g.tiles_w) {
      q.tx = 0;
      if (++q.ty == g.tiles_h) {
        q.ty = 0;
        if (++q.b == p.B) q.b = 0, ++q.slice;
      }
    }
  };
  Pos first;
  first.slice = t_begin / per_slice;
  first.tx = t_begin % g.tiles_w;
  first.ty = t_begin / g.tiles_w % g.tiles_h;
  first.b = t_begin / g.tiles_w / g.tiles_h % p.B;

  // thread 0's next load: the box of tile `ld` into stage ld_s
  const CUtensorMap* map = &tm_x;
  Pos ld_pos = first;
  int ld = 0, ld_s = 0;
  const auto issue_next = [&]() {
    hopper::mbar_expect_tx(&hd.full[ld_s], g.box_bytes);
    hopper::tma_load_4d(stages + ld_s * g.stage_bytes, map, &hd.full[ld_s], ld_pos.slice * kTC,
                        ld_pos.tx * g.tile_w - kPad, ld_pos.ty * g.tile_h - kPad, ld_pos.b);
    ++ld;
    if (++ld_s == g.stages) ld_s = 0;
    advance(ld_pos);
  };
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hopper::mbar_init(&hd.full[s], 1);
      hopper::mbar_init(&hd.empty[s], n_warps);
    }
    hopper::mbar_init_fence();
    // the first box, asked for first and alone: the other stages fill once
    // it has landed, so the memory serves every block's first box first
    if (n > 0) issue_next();
  }
  __syncthreads();

  const int sw = g.tile_w + kHalo;                   // staged columns
  const bool c_outer = p.w_s[2] > p.w_s[1];          // weights stored channel by channel
  Pos pos = first;
  int i = 0, s = 0, parity = 0;
  while (i < n) {
    // a run of the block's tiles in one channel slice: its weights, each
    // thread's share loaded into registers, then staged as fp32 [tap][32]
    const int slice = pos.slice;
    const int run_end = min(n, (slice + 1) * per_slice - t_begin);
    const int c = slice * kTC + lane;
    float bc;
    int taps[kShare], chans[kShare];
    bool ok[kShare];
    float share[kShare];
#pragma unroll
    for (int u = 0; u < kShare; ++u) {
      const int k = tid + u * blockDim.x;
      const int cl = c_outer ? k / kTaps : k % kTC;
      taps[u] = c_outer ? k % kTaps : k / kTC;
      chans[u] = slice * kTC + cl;
      ok[u] = k < kTaps * kTC && chans[u] < p.C;
    }
    load_params(p, taps, chans, ok, share, c, c < p.C, bc);
    __syncthreads();                                 // every warp holds the last slice's weights
#pragma unroll
    for (int u = 0; u < kShare; ++u) {
      const int k = tid + u * blockDim.x;
      const int cl = c_outer ? k / kTaps : k % kTC, tap = c_outer ? k % kTaps : k / kTC;
      if (k < kTaps * kTC) hd.w[tap][cl] = share[u];
    }
    __syncthreads();
    float wt[kTaps];
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) wt[tap] = hd.w[tap][lane];
    if (i == 0 && tid == 0) {
      // the rest of the ring, once the first box has landed (outside the
      // tile loop, whose code stays small)
      hopper::mbar_wait(&hd.full[0], 0);
      while (ld < n && ld < g.stages) issue_next();
    }

    for (; i < run_end; ++i) {
      hopper::mbar_wait(&hd.full[s], parity);
      const T* base = reinterpret_cast<const T*>(stages + s * g.stage_bytes) +
                      (wr * R * sw + wc * CW) * kTC + lane;
      float acc[R][CW];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int o = 0; o < CW; ++o) acc[r][o] = 0.f;
#pragma unroll
      for (int iy = 0; iy < R + kHalo; ++iy) {
        const T* row = base + iy * sw * kTC;
#pragma unroll
        for (int j = 0; j < CW + kHalo; ++j) {
          const float v = to_f32(row[j * kTC]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dy = iy - r;            // the tap row that output row r reads here
            if (dy < 0 || dy >= kK) continue;
#pragma unroll
            for (int dx = 0; dx < kK; ++dx) {
              const int o = j - dx;           // the output column that reads column j at dx
              if (o >= 0 && o < CW) acc[r][o] = fmaf(v, wt[dy * kK + dx], acc[r][o]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive(&hd.empty[s]);
        hopper::bulk_wait_read();            // the last tile's store has read the box
      }
      __syncwarp();
      // the outputs through the warp's box: TMA writes what lies inside the
      // tensor and drops the rest, so no position or channel is tested here
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int o = 0; o < CW; ++o) store_as(obox + (r * CW + o) * kTC + lane, acc[r][o] + bc);
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        hopper::tma_store_4d(&tm_out, obox, slice * kTC, pos.tx * g.tile_w + wc * CW,
                             pos.ty * g.tile_h + wr * R, pos.b);
        hopper::bulk_commit();
      }
      if (tid == 0 && ld < n) {
        hopper::mbar_wait(&hd.empty[s], parity);   // every warp has read the stage
        issue_next();                              // into this stage
      }
      advance(pos);
      if (++s == g.stages) s = 0, parity ^= 1;
    }
  }
  if (lane == 0) hopper::bulk_wait_read();   // the box stays until its last store has read it
}

// The instantiated register blocks, (R output rows, CW output columns) a
// thread: those _dw_plan can give (dwconv.py DW_INSTANCES, which must list
// the same pairs, in this order).
#define DW_TMA_INSTANCES(X) X(4, 4)

template <typename T>
const void* tma_kernel_of(int rows, int cols) {
#define DW_TMA_CASE(R, CW) \
  if (rows == R && cols == CW) return (const void*)dwconv7x7_tma_kernel<T, R, CW>;
  DW_TMA_INSTANCES(DW_TMA_CASE)
#undef DW_TMA_CASE
  return nullptr;
}

const void* tma_kernel(int dtype, int rows, int cols) {
  if (dtype == 0) return tma_kernel_of<float>(rows, cols);
  if (dtype == 1) return tma_kernel_of<__nv_bfloat16>(rows, cols);
  return nullptr;
}

uint32_t box_bytes(int dtype, int tile_h, int tile_w) {
  return (uint32_t)kTC * (tile_w + kHalo) * (tile_h + kHalo) * (dtype == 0 ? 4 : 2);
}

// Dynamic shared memory of a launch: the head, each warp's output box and
// `stages` input boxes.
size_t tma_smem_bytes(int dtype, int rows, int cols, int warps, int tile_h, int tile_w,
                      int stages) {
  const size_t out_box = (size_t)rows * cols * kTC * (dtype == 0 ? 4 : 2);
  return sizeof(Head) + warps * out_box +
         (size_t)stages * ((box_bytes(dtype, tile_h, tile_w) + 127) / 128 * 128);
}

// ---------------------------------------------------------------------------
// dwconv7x7_kernel: the first port's kernel
// ---------------------------------------------------------------------------

constexpr int kTH = 8;                  // output rows per block (one per warp)
constexpr int kTW = 16;                 // output columns per block (per thread)
constexpr int kSH = kTH + kHalo;        // staged rows
constexpr int kSW = kTW + kHalo;        // staged columns
constexpr int kThreads = kTH * kTC;     // 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dwconv7x7_kernel(const T* __restrict__ x, Params p) {
  __shared__ float tile[kSH][kSW][kTC];
  const int H = p.H, W = p.W, C = p.C;
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
  int taps[kTaps], chans[kTaps];
  bool ok[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) taps[i] = i, chans[i] = c, ok[i] = true;
  float wr[kTaps];
  float bc;
  load_params(p, taps, chans, ok, wr, c, true, bc);
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
  T* orow = static_cast<T*>(p.out) + (((int64_t)b * H + h) * W + w0) * C + c;
#pragma unroll
  for (int o = 0; o < kTW; ++o) {
    if (w0 + o < W) store_as(orow + (int64_t)o * C, acc[o] + bc);
  }
}

Params make_params(int w_dtype, const void* w, long long s_dy, long long s_dx, long long s_c,
                   int b_dtype, const void* bias, long long s_b, void* out, int B, int H, int W,
                   int C) {
  Params p;
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.w_s[0] = s_dy;
  p.w_s[1] = s_dx;
  p.w_s[2] = s_c;
  p.b_s = s_b;
  p.w_bf16 = w_dtype == 1;
  p.b_bf16 = b_dtype == 1;
  p.B = B, p.H = H, p.W = W, p.C = C;
  return p;
}

using hopper_host::refused;
using hopper_host::smem_fits;

bool bad_dtypes(int dtype, int w_dtype, int b_dtype) {
  return (dtype != 0 && dtype != 1) || (w_dtype != 0 && w_dtype != 1) ||
         (b_dtype != 0 && b_dtype != 1);
}

}  // namespace

extern "C" {

// dtype, w_dtype, b_dtype: 0 = float32, 1 = bfloat16. x and out [B, H, W, C]
// contiguous in dtype; w [7, 7, C] at element strides (s_dy, s_dx, s_c) and
// bias [C] at s_b, each in its own dtype. The first port's kernel
// (dwconv7x7_kernel). Returns a cudaError_t.
int cambrian_dwconv7x7(int dtype, const void* x, int w_dtype, const void* w, long long s_dy,
                       long long s_dx, long long s_c, int b_dtype, const void* bias,
                       long long s_b, void* out, int B, int H, int W, int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || bad_dtypes(dtype, w_dtype, b_dtype))
    return (int)cudaErrorInvalidValue;
  const int c_tiles = (C + kTC - 1) / kTC;
  if ((int64_t)B * c_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * c_tiles);
  const Params p = make_params(w_dtype, w, s_dy, s_dx, s_c, b_dtype, bias, s_b, out, B, H, W, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dwconv7x7_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), p);
  } else {
    dwconv7x7_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), p);
  }
  return (int)cudaGetLastError();
}

// How many blocks of dwconv7x7_tma_kernel<dtype, rows, cols> of `warps`
// warps, with tiles of tile_h x tile_w outputs in `stages` stages, one SM
// holds at once, into *blocks: 0 where a block's shared memory exceeds what
// one may take.
int cambrian_dwconv7x7_tma_occupancy(int dtype, int rows, int cols, int warps, int tile_h,
                                     int tile_w, int stages, int* blocks) {
  const void* fn = tma_kernel(dtype, rows, cols);
  if (fn == nullptr || warps < kMinWarps || warps > kMaxWarps || stages < kMinStages ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tma_smem_bytes(dtype, rows, cols, warps, tile_h, tile_w, stages);
  *blocks = 0;
  if (!smem_fits(smem)) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return refused(err);
  return refused(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, warps * 32, smem));
}

// dwconv7x7_tma_kernel under a DwPlan of ops/dwconv.py: register blocks of
// rows x cols outputs a thread, warps_h x warps_w warps a block (a tile of
// rows warps_h x cols warps_w outputs x 32 channels), `stages` stages,
// `blocks` persistent blocks. Operands as cambrian_dwconv7x7's, but x must
// be 16-byte aligned with C * sizeof(dtype) a multiple of 16 (TMA). Refuses,
// launching nothing, what the kernel cannot take: no such instance, a tile
// side over 250, fewer than 4 or more than 8 warps, fewer than 2 or more
// than 4 stages, more blocks than tiles,
// or a tensor map that libcuda refuses (more shared memory than a block may
// take is refused by the runtime). How many blocks the card holds at
// once is the plan's rule (it asks cambrian_dwconv7x7_tma_occupancy, once a
// shape): any grid is correct.
int cambrian_dwconv7x7_tma(int dtype, const void* x, int w_dtype, const void* w, long long s_dy,
                           long long s_dx, long long s_c, int b_dtype, const void* bias,
                           long long s_b, void* out, int B, int H, int W, int C, int rows,
                           int cols, int warps_h, int warps_w, int stages, int blocks,
                           void* stream) {
  const void* fn = tma_kernel(dtype, rows, cols);
  const int es = dtype == 0 ? 4 : 2;
  if (fn == nullptr || bad_dtypes(dtype, w_dtype, b_dtype) || B < 1 || H < 1 || W < 1 ||
      C < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || ((int64_t)C * es) % 16 != 0 ||
      warps_h < 1 || warps_w < 1 || warps_h * warps_w < kMinWarps ||
      warps_h * warps_w > kMaxWarps || stages < kMinStages ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  Tiles g;
  g.warps_h = warps_h, g.warps_w = warps_w;
  g.tile_h = rows * warps_h, g.tile_w = cols * warps_w;
  if (g.tile_h + kHalo > 256 || g.tile_w + kHalo > 256) return (int)cudaErrorInvalidValue;
  g.tiles_h = (H + g.tile_h - 1) / g.tile_h;
  g.tiles_w = (W + g.tile_w - 1) / g.tile_w;
  const int64_t tiles = (int64_t)((C + kTC - 1) / kTC) * B * g.tiles_h * g.tiles_w;
  if (tiles > INT32_MAX || blocks < 1 || blocks > tiles) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.stages = stages;
  g.box_bytes = box_bytes(dtype, g.tile_h, g.tile_w);
  g.stage_bytes = (g.box_bytes + 127) / 128 * 128;
  CUtensorMap tm_x, tm_out;
  const CUtensorMapDataType type =
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hopper_host::nhwc_box_map(&tm_x, type, es, x, B, H, W, C, kTC, g.tile_w + kHalo,
                                 g.tile_h + kHalo) ||
      !hopper_host::nhwc_box_map(&tm_out, type, es, out, B, H, W, C, kTC, cols, rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      tma_smem_bytes(dtype, rows, cols, warps_h * warps_w, g.tile_h, g.tile_w, stages);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return refused(err);
  Params p = make_params(w_dtype, w, s_dy, s_dx, s_c, b_dtype, bias, s_b, out, B, H, W, C);
  void* args[] = {(void*)&tm_x, (void*)&tm_out, (void*)&p, (void*)&g};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(warps_h * warps_w * 32), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
