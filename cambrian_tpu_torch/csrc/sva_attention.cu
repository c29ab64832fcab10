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
// and values once (no query shares a key with another, so nothing can be
// reused), and its ~4 W D operations are CUDA-core work on a [D] x [W, D]
// product too small for the tensor cores: at the 8B site (B 1, Q 576, W 19,
// H 16, D 64, bf16) 47.2 MB against 46 M operations, 14.1 us of bytes at
// 3.35 TB/s against 0.7 us of fp32 issue. So the design question is only how
// the bytes move: enough of them in flight on every SM, all the time.
//
// sva_attention_tma_kernel<T, LR, MW>, the route for operands TMA can address
// (q, k and v dense along (h, d), their (b, q[, w]) axes one row stride of a
// multiple of 16 bytes, 16-byte-aligned bases, D x sizeof(T) a multiple of
// 16 bytes):
// - The unit of work is one query and G heads (the plan's `heads`; G D <=
//   256, TMA's limit on a box side). Three 2-D tensor maps, encoded once a
//   call: q as [B Q rows, H D columns], k and v as [B Q W rows, H D
//   columns]. A unit's q is one box of 1 x G D, its K window one box of W x
//   G D, its V window another: at the 8B site 512 + 2 x 9,728 bytes.
// - A persistent grid (the plan's blocks, all resident at once): block k
//   takes units [k U / G, (k + 1) U / G) in memory order, walking their
//   positions by counting, without a division.
// - Each block is G compute warps and one producer warp. The producer's
//   elected lane keeps a ring of 2-8 stages full (a full and an empty
//   mbarrier a stage): it waits for a stage to be released, announces the
//   unit's bytes and asks for its three boxes. So every SM keeps its blocks'
//   next units in flight while it computes (the plan sizes blocks x stages
//   for >= 32 KB an SM) and no compute warp waits on a load it issued.
// - Compute warp j owns head j of the unit. Its lanes form 32 / LR groups of
//   LR lanes (LR = D x sizeof(T) / 16 rounded up to a power of two >= 8; a
//   spare lane, as at D = 72, reads the last piece with a zero q): a group
//   reads one key row in 16-byte pieces, a piece a lane, so a warp takes 32
//   / LR keys a pass (4 at bf16 D = 64). A key's dot product is a lane's
//   FMAs over its piece and log2(LR) shuffles within the group; the logits
//   stay in registers (MW / (32 / LR) of them: the window class MW, 32 or
//   64 keys, bounds W). The passes run in steps of up to 8 (all 5 at the 8B
//   site) whose loads, FMAs and shuffles overlap; rows past W read row W - 1
//   and take logit -inf, so no load is predicated. The masked max and the
//   sum run over a lane's passes, then across the groups (log2(32 / LR)
//   shuffles). PV: each lane accumulates p_w v[w] over its group's keys for
//   its piece; the groups are summed by shuffles and group 0 stores the row
//   in 16-byte pieces. Everything accumulates in fp32.
// - Shared-memory reads are conflict-free: each quarter warp (the unit of a
//   16-byte shared load) reads 128 contiguous bytes of one row, since LR >= 8.
// - The mask ([B, Q, W] or [B, Q, H, W] bool through strides, or none) is
//   read with plain loads, two bytes a lane, one unit ahead, and turned into
//   a 64-bit key mask by two ballots.
// What held the first form of this kernel back was the compute's latency,
// not the ring: with every pass a branch and its own load-FMA-shuffle chain,
// a warp's unit took ~2,450 SM cycles and a block's units queued behind it;
// steps of overlapping passes and branch-free loads cut that to ~1,380
// (scripts/sva_phases.py --bps 1; PERF.md, PR 13).
//
// sva_attention_kernel<T>, the first port's kernel, takes the rest (and
// anything forced onto it): one warp a (b, q, h), q, k, v and out read
// through their strides with a unit stride along D, 2-byte loads at d = lane
// and lane + 32, a warp-shuffle sum per key.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// sva_attention_tma_kernel
// ---------------------------------------------------------------------------

constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kMaxUnitHeads = 8;        // compute warps a block
constexpr int kMaxBoxCols = 256;        // TMA's limit on a box side

// A launch of the TMA kernel, as the plan (_sva_plan in
// ops/sva_attention.py) gives it; the byte counts come from tma_layout.
struct TmaArgs {
  const uint8_t* mask;      // bool, or null for no mask
  int64_t m_s[4];           // b, q, h (0 for a [B, Q, W] mask), w
  void* out;                // [B, Q, H, D], contiguous
  float scale;
  int Q, H, W, D;
  int heads;                // G: heads a unit, a compute warp each
  int units;                // B Q H / G, a query's units in head order
  int stages;
  uint32_t q_bytes;         // a unit's q box: G D elements
  uint32_t kv_bytes;        // its K box (and its V box): W G D elements
  uint32_t k_off, v_off;    // the K and V boxes' offsets in a stage
  uint32_t stage_bytes;
};

// The head of shared memory; the stages follow it.
struct alignas(128) TmaHead {
  uint64_t full[kMaxStages];    // a stage's boxes have landed (TMA's transaction count)
  uint64_t empty[kMaxStages];   // every compute warp has read the stage
};

// 16 bytes of shared memory as fp32: 8 bf16 (a 16-bit shift each, exact) or
// 4 floats.
__device__ __forceinline__ void widen16(const uint8_t* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen16(const uint8_t* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
}

// acc x inv as 16 bytes of T at p (global memory).
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&acc)[8], float inv) {
  uint4 r;
  r.x = hopper::pack_bf16(acc[0] * inv, acc[1] * inv);
  r.y = hopper::pack_bf16(acc[2] * inv, acc[3] * inv);
  r.z = hopper::pack_bf16(acc[4] * inv, acc[5] * inv);
  r.w = hopper::pack_bf16(acc[6] * inv, acc[7] * inv);
  *reinterpret_cast<uint4*>(p) = r;
}
__device__ __forceinline__ void store16(float* p, const float (&acc)[4], float inv) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv,
                                              acc[3] * inv);
}

// N passes of a unit's QK or PV, as a type, so that a pass count chosen at
// run time selects code whose N passes overlap.
template <int N>
using Passes = std::integral_constant<int, N>;

// Registers: the classes of 8 passes (the 8B site's <bf16, 8, 32>: 88) are
// held to two blocks of 9 warps an SM (96 registers a thread), so four
// blocks of 4 + 1 warps fit; longer classes spill under that cap, and take
// what they need.
template <typename T, int LR, int MW>
__global__ void __launch_bounds__((kMaxUnitHeads + 1) * 32, MW / (32 / LR) <= 8 ? 2 : 1)
    sva_attention_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, TmaArgs a) {
  constexpr int kE = 16 / (int)sizeof(T);     // elements in a 16-byte piece
  constexpr int kKP = 32 / LR;                // keys a pass: the lane groups
  constexpr int kPasses = MW / kKP;           // passes of the class's longest window
  constexpr int kStep = 8;                    // passes in flight together, at most
  static_assert(kPasses % kStep == 0, "whole steps");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  TmaHead& hd = *reinterpret_cast<TmaHead*>(smem_raw);
  uint8_t* stages = smem_raw + sizeof(TmaHead);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int u_begin = (int)((int64_t)blockIdx.x * a.units / gridDim.x);
  const int n = (int)((int64_t)(blockIdx.x + 1) * a.units / gridDim.x) - u_begin;
  const int groups = a.H / a.heads;           // units a query
  const int unit_cols = a.heads * a.D;        // a unit's columns of a row
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(&hd.full[s], 1);
      hopper::mbar_init(&hd.empty[s], a.heads);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == a.heads) {
    // the producer: one elected lane keeps the ring full, walking the
    // units' (row, column) without a division
    if (lane == 0) {
      const uint32_t tx = a.q_bytes + 2 * a.kv_bytes;
      int row = u_begin / groups, col = u_begin % groups * unit_cols;   // b Q + q; h D
      int s = 0, round = 0;
      for (int i = 0; i < n; ++i) {
        if (round > 0) hopper::mbar_wait(&hd.empty[s], (round - 1) & 1);
        uint8_t* st = stages + s * a.stage_bytes;
        hopper::mbar_expect_tx(&hd.full[s], tx);
        hopper::tma_load_2d(st, &tm_q, &hd.full[s], col, row);
        hopper::tma_load_2d(st + a.k_off, &tm_k, &hd.full[s], col, row * a.W);
        hopper::tma_load_2d(st + a.v_off, &tm_v, &hd.full[s], col, row * a.W);
        if (++s == a.stages) s = 0, ++round;
        if ((col += unit_cols) == a.H * a.D) col = 0, ++row;
      }
    }
    return;
  }

  const int grp = lane / LR, sub = lane % LR;     // key group; 16-byte piece of a row
  const int pieces = a.D * (int)sizeof(T) / 16;
  const bool active = sub < pieces;
  const int passes = (a.W + kKP - 1) / kKP;
  const uint32_t pitch = unit_cols * sizeof(T);    // a box row in shared memory
  // the lane's piece of its head's row; a spare lane reads the last piece
  // with a zero q, so no load is predicated or branched around
  const uint32_t lane_off = warp * a.D * sizeof(T) + min(sub, pieces - 1) * 16;
  // the output: unit u's head `warp` at (u heads + warp) D, contiguous
  T* op = static_cast<T*>(a.out) + ((int64_t)u_begin * a.heads + warp) * a.D + sub * kE;

  // the mask one unit ahead: the next unit's (head group, query) and its
  // query's offset, walked without a division; bytes of keys lane and
  // lane + 32 (1 without a mask, or past the block's units)
  int m_g = u_begin % groups, m_q = u_begin / groups % a.Q;
  int64_t m_row = (int64_t)(u_begin / groups / a.Q) * a.m_s[0] + (int64_t)m_q * a.m_s[1];
  const auto next_mask = [&](bool live, uint32_t& m0, uint32_t& m1) {
    m0 = m1 = 1;
    if (a.mask != nullptr && live) {
      const uint8_t* mp = a.mask + m_row + (int64_t)(m_g * a.heads + warp) * a.m_s[2];
      m0 = lane < a.W ? mp[lane * a.m_s[3]] : 0;
      m1 = lane + 32 < a.W ? mp[(lane + 32) * a.m_s[3]] : 0;
    }
    if (++m_g == groups) {
      m_g = 0;
      m_row += a.m_s[1];
      if (++m_q == a.Q) m_q = 0, m_row += a.m_s[0] - (int64_t)a.Q * a.m_s[1];
    }
  };
  uint32_t m0, m1;
  next_mask(true, m0, m1);
  int s = 0, parity = 0;
  for (int i = 0; i < n; ++i) {
    const uint64_t keys = (uint64_t)__ballot_sync(0xffffffffu, m0 != 0) |
                          ((uint64_t)__ballot_sync(0xffffffffu, m1 != 0) << 32);
    next_mask(i + 1 < n, m0, m1);                 // in flight while this unit computes
    hopper::mbar_wait(&hd.full[s], parity);
    const uint8_t* st = stages + s * a.stage_bytes;
    float qf[kE];
    widen16(st + lane_off, qf);
#pragma unroll
    for (int e = 0; e < kE; ++e) qf[e] = active ? qf[e] : 0.f;
    // key w's row of K or V: rows past W read row W - 1, whose logit is
    // then -inf and whose weight 0
    const auto row = [&](uint32_t box, int w) {
      return st + box + min(w, a.W - 1) * pitch + lane_off;
    };

    // logits: pass p, group grp takes key p kKP + grp. The passes go in
    // steps of up to 8 (exactly the window's passes at the 8B site) whose
    // loads, FMAs and shuffles overlap; no pass past the window is computed
    float logit[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) logit[p] = -CUDART_INF_F;
    const auto qk = [&](auto step, int p0) {
      constexpr int N = decltype(step)::value;
      float part[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float kf[kE];
        widen16(row(a.k_off, (p0 + j) * kKP + grp), kf);
        part[j] = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) part[j] = fmaf(qf[e], kf[e], part[j]);
      }
#pragma unroll
      for (int off = LR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < N; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        // keys past W take no weight; masked keys sit at the finite NEG_INF
        const int w = (p0 + j) * kKP + grp;
        if (w < a.W) logit[p0 + j] = (keys >> w) & 1 ? part[j] * a.scale : kNegInf;
      }
    };
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    const auto pv = [&](auto step, int p0) {
      constexpr int N = decltype(step)::value;
      float vf[N][kE];
#pragma unroll
      for (int j = 0; j < N; ++j) widen16(row(a.v_off, (p0 + j) * kKP + grp), vf[j]);
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(logit[p0 + j], vf[j][e], acc[e]);
    };
    // the passes [0, passes) of f: steps of kStep, the last one exactly as
    // long as the passes left
    const auto each_pass = [&](const auto& f) {
#pragma unroll
      for (int p0 = 0; p0 < kPasses; p0 += kStep) {
        switch (passes - p0) {
          case 1: f(Passes<1>(), p0); break;
          case 2: f(Passes<2>(), p0); break;
          case 3: f(Passes<3>(), p0); break;
          case 4: f(Passes<4>(), p0); break;
          case 5: f(Passes<5>(), p0); break;
          case 6: f(Passes<6>(), p0); break;
          case 7: f(Passes<7>(), p0); break;
          default:
            if (passes - p0 >= kStep) f(Passes<kStep>(), p0);
        }
      }
    };

    each_pass(qk);
    float mx = logit[0];
#pragma unroll
    for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, logit[p]);
#pragma unroll
    for (int off = LR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (p < passes) {
        logit[p] = expf(logit[p] - mx);
        sum += logit[p];
      }
    }
#pragma unroll
    for (int off = LR; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    each_pass(pv);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&hd.empty[s]);   // the warp has read the stage
#pragma unroll
    for (int off = LR; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (grp == 0 && active) store16(op, acc, 1.f / sum);
    op += unit_cols;
    if (++s == a.stages) s = 0, parity ^= 1;
  }
}

// The (lanes a key row, window class) pairs _sva_plan can give
// (sva_attention.py SVA_LANES x SVA_WINDOWS, which must list the same
// values, in this order). A window class is the longest window it takes: 32
// or 64 keys. Each dtype is instantiated at the lanes its rows can need: a
// row of D <= 128 is at most 8 sizeof(T) pieces (bf16: 16 lanes).
#define SVA_TMA_INSTANCES(X) X(8, 32) X(8, 64) X(16, 32) X(16, 64) X(32, 32) X(32, 64)

template <typename T>
const void* tma_kernel_of(int lanes, int window) {
#define SVA_TMA_CASE(LR, MW)                                                            \
  if constexpr (LR <= 8 * (int)sizeof(T)) {                                             \
    if (lanes == LR && window == MW) return (const void*)sva_attention_tma_kernel<T, LR, MW>; \
  }
  SVA_TMA_INSTANCES(SVA_TMA_CASE)
#undef SVA_TMA_CASE
  return nullptr;
}

const void* tma_kernel(int dtype, int lanes, int window) {
  if (dtype == 0) return tma_kernel_of<float>(lanes, window);
  if (dtype == 1) return tma_kernel_of<__nv_bfloat16>(lanes, window);
  return nullptr;
}

uint32_t round128(uint32_t bytes) { return (bytes + 127) / 128 * 128; }

// A stage's layout (q box, K box, V box, each at a 128-byte boundary) into
// a; returns the launch's dynamic shared memory: the head and `stages`
// stages.
size_t tma_layout(TmaArgs& a, int es, int heads, int W, int D, int stages) {
  a.q_bytes = (uint32_t)heads * D * es;
  a.kv_bytes = (uint32_t)W * heads * D * es;
  a.k_off = round128(a.q_bytes);
  a.v_off = a.k_off + round128(a.kv_bytes);
  a.stage_bytes = a.v_off + round128(a.kv_bytes);
  return sizeof(TmaHead) + (size_t)stages * a.stage_bytes;
}

// What the TMA kernel cannot take, shapes only: no instance at (lanes,
// window), a window past its class, pieces past the lanes, a unit over TMA's
// box side or 8 heads, heads that do not divide H, stages outside 2..8.
bool bad_tma_shape(int dtype, int lanes, int window, int heads, int H, int W, int D,
                   int stages) {
  const int es = dtype == 0 ? 4 : 2;
  return tma_kernel(dtype, lanes, window) == nullptr || W < 1 || W > window || D < 1 ||
         D > kMaxHeadDim || (D * es) % 16 != 0 || D * es / 16 > lanes || heads < 1 ||
         heads > kMaxUnitHeads || H % heads != 0 || heads * D > kMaxBoxCols ||
         stages < kMinStages || stages > kMaxStages;
}

using hopper_host::refused;
using hopper_host::smem_fits;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides in
// elements: q_s/o_s (b, q, h), k_s/v_s (b, q, w, h), m_s (b, q, h, w); the
// last axis of q, k, v and out has a unit stride. mask may be null. The
// first port's kernel (sva_attention_kernel). Returns a cudaError_t (0 on
// success).
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

// How many blocks of sva_attention_tma_kernel<dtype, lanes, window> with
// units of `heads` heads (heads + 1 warps) over windows of W keys of head
// dim D, in `stages` stages, one SM holds at once, into *blocks: 0 where a
// block's shared memory exceeds what one may take.
int cambrian_sva_attention_tma_occupancy(int dtype, int lanes, int window, int heads, int W,
                                         int D, int stages, int* blocks) {
  if (bad_tma_shape(dtype, lanes, window, heads, heads, W, D, stages))
    return (int)cudaErrorInvalidValue;
  const void* fn = tma_kernel(dtype, lanes, window);
  TmaArgs a;
  const size_t smem = tma_layout(a, dtype == 0 ? 4 : 2, heads, W, D, stages);
  *blocks = 0;
  if (!smem_fits(smem)) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return refused(err);
  return refused(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, (heads + 1) * 32, smem));
}

// sva_attention_tma_kernel under an SvaPlan of ops/sva_attention.py: LR =
// `lanes` lanes a key row, the window class `window`, units of `heads`
// heads, `stages` stages, `blocks` persistent blocks. q [B, Q, H, D] and k, v [B, Q, W, H, D] are
// dense along (h, d) with one row stride each (elements) along their
// flattened (b, q) and (b, q, w) axes: q_row, k_row, v_row, each at least H
// D and a multiple of 16 bytes, with 16-byte-aligned bases; out [B, Q, H, D]
// contiguous and 16-byte aligned; the mask as cambrian_sva_attention's.
// Refuses, launching nothing, what the kernel cannot take (bad_tma_shape,
// the operands' rules, more blocks than units, B Q W past 2^31 rows) or a
// tensor map that libcuda refuses. How many blocks the card holds at once is
// the plan's rule (it asks cambrian_sva_attention_tma_occupancy, once a
// shape): any grid is correct.
int cambrian_sva_attention_tma(int dtype, const void* q, const void* k, const void* v,
                               const uint8_t* mask, void* out, long long q_row,
                               long long k_row, long long v_row, const int64_t* m_s, int B,
                               int Q, int H, int W, int D, float scale, int lanes, int window,
                               int heads, int stages, int blocks, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const int64_t hd = (int64_t)H * D, rows = (int64_t)B * Q;
  if (bad_tma_shape(dtype, lanes, window, heads, H, W, D, stages) || B < 1 || Q < 1 ||
      rows * W > INT32_MAX || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out) || q_row < hd || k_row < hd || v_row < hd || (q_row * es) % 16 != 0 ||
      (k_row * es) % 16 != 0 || (v_row * es) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t units = rows * (H / heads);
  if (units > INT32_MAX || blocks < 1 || blocks > units) return (int)cudaErrorInvalidValue;
  TmaArgs a;
  a.mask = mask;
  for (int i = 0; i < 4; ++i) a.m_s[i] = mask == nullptr ? 0 : m_s[i];
  a.out = out;
  a.scale = scale;
  a.Q = Q, a.H = H, a.W = W, a.D = D;
  a.heads = heads;
  a.units = (int)units;
  a.stages = stages;
  const size_t smem = tma_layout(a, es, heads, W, D, stages);
  const CUtensorMapDataType type =
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box = (uint32_t)heads * D;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hopper_host::tile_map_2d(&tm_q, type, q, hd, rows, q_row * es, box, 1,
                                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper_host::tile_map_2d(&tm_k, type, k, hd, rows * W, k_row * es, box, W,
                                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper_host::tile_map_2d(&tm_v, type, v, hd, rows * W, v_row * es, box, W,
                                CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const void* fn = tma_kernel(dtype, lanes, window);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return refused(err);
  void* args[] = {(void*)&tm_q, (void*)&tm_k, (void*)&tm_v, (void*)&a};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3((heads + 1) * 32), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
}

const char* cambrian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
