// Flash-attention forward on Hopper: online-softmax attention with causal
// masking, grouped-query heads, a sliding window and a logit softcap.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (its Pallas
// TPU _kernel), which the model's prefill runs once per layer through
// kernels/ops.py::flash_attention. The TPU kernel walks a sequential
// (B, H, Sq/128, Sk/128) grid with the running max, denominator and
// accumulator in VMEM scratch, and pads hd and S to 128 for the MXU; none
// of that tiling carries over. What it computes does:
//   * scores q.k scaled by 1/sqrt(hd) of the real head dim, then softcap
//     c*tanh(s/c), then the mask: causal kj <= qi and, with a window,
//     kj > qi - window, query and key positions both counted from 0;
//   * masked scores are the finite -1e30 (a -inf start for the running max
//     would give exp(-inf - -inf) = NaN); key tiles wholly masked for a
//     64-row query tile are skipped;
//   * running max, denominator and accumulator in f32; the output is
//     acc / max(l, 1e-30) in q's dtype.
// Keys past Sk (the ragged last tile) score -inf, so they add exactly 0:
// the kernels take any Sq and Sk, where the TPU wrapper padded to 128, and
// hd 16, 32, 64, 112, 128 or 192 (the configs' head dims), where it padded
// hd to 128.
//
// What bounds it: operations. Each (query, key) pair costs 4*hd flops
// (q.k and p*v) and the pairs grow as S^2, while the bytes grow as S*hd: at
// the qwen1.5-0.5b prefill shape (B 2, H 16, S 4096, hd 64, causal) one
// launch needs 68.7 GFLOP against 67 MB in bf16, about 1,000 flops a byte.
//
// Two paths, chosen before launch from dtype alone (the wrapper's
// kernel_path), both one kernel template on the tensor cores,
// `tc::flash_wgmma<HD, kSplit>` (989 TFLOP/s dense bf16):
//
// * One CTA per (head, batch, 128-query tile), the longest query tiles
//   first (the causal frontier makes late tiles the heaviest).
// * Warp specialisation, 384 threads: a producer warpgroup (one thread
//   issues, 40 registers) loads the Q tile once and 64-key K and V tiles
//   into a ring of stages, by TMA on 4D tensor maps over (hd, S, heads, B),
//   one mbarrier a stage. Rows are cut into chunks of the swizzle width:
//   64 columns with the 128-byte swizzle (hd 112 is laid out as 128, TMA
//   zero-filling the pad; hd 192 as three chunks), hd 32 and 16 whole with
//   the 64- and 32-byte swizzles.
// * Two consumer warpgroups (232 registers) own 64 query rows each:
//   S = Q.K^T by wgmma m64n64k16 from shared memory (both K-major), then
//   scale, softcap, mask, row max and row sum on the accumulator's own
//   fragments in registers (a row lives in the four threads of a quad: two
//   shuffles), scores kept in the log2 domain so exp2 gives exp; P is the
//   register A operand of O += P.V (wgmma m64nNk16, N the padded hd; V is
//   MN-major, hd contiguous: the transpose bit). O (up to 96 f32 a thread
//   at hd 192) stays in registers and is stored masked to (Sq, hd).
// * Each warpgroup skips the compute of key tiles outside its own 64
//   rows' range but still waits for and releases every stage. The ranges
//   are those of 64-row query groups, so a fully masked row (a window with
//   no key in it) averages V over the same keys as the Pallas kernel and
//   the port's earlier FMA kernel did.
//
// 1. bf16, "wgmma": Q, K and V are the caller's tensors, read in place
//    through their strides (the model's (B, S, H, hd) tensors pass as
//    transposed views). P is rounded to bf16 in registers: the one
//    numerical difference from the TPU kernel, which multiplies V by p in
//    f32; it stays well inside the bf16 tolerance. O is stored as bf16
//    pairs. Two stages of K and V.
// 2. f32, "wgmma_split": every f32 operand v is split into bf16 hi =
//    bf16(v) and lo = bf16(v - hi) (hopper.cuh, |v - hi - lo| <= 2^-18
//    |v|) and each product runs as three, in this order, into one f32
//    accumulator: S = Q_hi.K_hi^T + Q_hi.K_lo^T + Q_lo.K_hi^T, O += P_hi.V_hi
//    + P_lo.V_hi + P_hi.V_lo (lo.lo is below f32's rounding). That is f32
//    accuracy at a third of the bf16 rate (bound 0.21 ms at the qwen shape,
//    where the CUDA cores' 67 TFLOP/s give 1.03 ms), and P is not rounded:
//    it is split in registers like the rest. TF32 would not do: 10 bits,
//    and its wgmma takes no MN-major B, which V is.
//    * The tensor cores round their f32 sums toward zero, and O collects
//      12 wgmmas a key tile over every key tile. At hd <= 64 (qwen's
//      prefill) P.V goes into a fresh partial (the first product
//      overwrites it), and O = fma(alpha, O, partial) on the CUDA cores
//      rounds to nearest: that took the qwen1.5-0.5b f32 prefill's K/V
//      states from 1.75e-4 to 7.0e-5 off the plain path (tolerance 2e-4).
//      At hd 112, 128 and 192, O holds 64 or 96 registers and a partial
//      beside it spilled (96-116 bytes; hd 112 1.85-1.94 ms against 1.68
//      without), so O keeps the tensor cores' sum there, 7.6e-5 off the
//      plain version at zamba2's hd 112 (tolerance 2e-4). S (12 to 36
//      products into a fresh tile each time) keeps the tensor cores' sum.
//    * q, k and v are split by a first pass, `split_qkv` (one launch for
//      the three, 16-byte loads and stores), into bf16 hi and lo planes,
//      each a contiguous (2B, heads, S, hd) scratch tensor from the
//      wrapper: hi at batches 0..B-1, lo at B..2B-1, so one tensor map
//      reads both. The pass moves the f32 bytes twice (read, write: ~0.2
//      GB, ~0.06 ms at the qwen shape) once a call, where a split in the
//      attention kernel would redo it for every query tile that reads a
//      K or V tile (S / 128 of them), and would need f32 staging tiles
//      beside the bf16 ones, which do not fit shared memory at hd >= 112.
//    * Shared memory holds Q hi and lo and, a stage, K hi, K lo, V hi and
//      V lo: 32 + 2 x 32 KB at hd 64, 64 + 2 x 64 KB at hd 112 and 128;
//      at hd 192, 96 KB of Q and a stage of 96 KB allow one stage only
//      (two would need 288 KB of the 227): the producer loads a tile while
//      the consumers run nothing else, so hd 192 waits for every load.
//    * O is stored as f32 pairs.
// ptxas (nvcc 12.9): 168 registers for both paths at every hd (the
// 384-thread launch bound caps what ptxas allocates; setmaxnreg: producer
// 40, consumers 232), no spills; split_qkv 28.
// No atomics and a fixed order of every sum: results repeat bitwise.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// split path's planes come from the wrapper) and return cudaGetLastError()
// (or a tensor-map error, hopper.cuh); the Python wrapper raises if that is
// not 0.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// the f32 path's first pass: q, k, v into bf16 hi and lo planes
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;

struct SplitArgs {
  const float* src[3];             // q, k, v: (B, heads, S, hd) views
  __nv_bfloat16* dst[3];           // each (2B, heads, S, hd) contiguous
  int64_t st[3][3];                // element strides of src's b, h, s
  int heads[3];
  int S[3];
  int B, hd;
};

// blockIdx.y picks q, k or v; a thread takes 8 f32 of a row at a time
// (hd % 8 == 0, rows 16-byte aligned) and writes 16 bytes of hi and of lo.
__global__ void __launch_bounds__(kSplitThreads)
split_qkv(SplitArgs a) {
  const int t = blockIdx.y;
  const int per_row = a.hd / 8;
  const int S = a.S[t];
  const int heads = a.heads[t];
  const int rows = a.B * heads * S;
  const int n = rows * per_row;
  const float* src = a.src[t];
  __nv_bfloat16* hi_plane = a.dst[t];
  __nv_bfloat16* lo_plane = hi_plane + static_cast<int64_t>(rows) * a.hd;
  for (int i = blockIdx.x * kSplitThreads + threadIdx.x; i < n;
       i += gridDim.x * kSplitThreads) {
    const int row = i / per_row;
    const int col = (i - row * per_row) * 8;
    const int s = row % S;
    const int bh = row / S;
    const int hh = bh % heads;
    const int bb = bh / heads;
    const float* from = src + bb * a.st[t][0] + hh * a.st[t][1] +
                        s * a.st[t][2] + col;
    const float4 v0 = __ldg(reinterpret_cast<const float4*>(from));
    const float4 v1 = __ldg(reinterpret_cast<const float4*>(from + 4));
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint4 vh, vl;
    hopper::split8(v, vh, vl);
    const int64_t to = static_cast<int64_t>(row) * a.hd + col;
    *reinterpret_cast<uint4*>(hi_plane + to) = vh;
    *reinterpret_cast<uint4*>(lo_plane + to) = vl;
  }
}

// ---------------------------------------------------------------------------
// the attention kernel: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;           // query rows per CTA: two warpgroups of 64
constexpr int kBKV = 64;           // keys per tile
constexpr int kThreads = 384;      // consumers 0-255, producer 256-383
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  void* o;                         // bf16 or f32, as the path
  int64_t os[3];                   // element strides of o's b, h, s
  int B;                           // batch; the split path's lo planes
                                   // start at batch B
  int H, KV, Sq, Sk;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no softcap
  float scale;
};

// Shared-memory geometry of one head dim and path. A tile's rows are cut
// into chunks of the swizzle width (64 columns, 128 bytes; hd 32 and 16
// take the 64- and 32-byte swizzles whole); hd 112 is laid out as 128
// columns, the last 16 zero-filled by TMA (the map's hd is 112). The split
// path keeps two bf16 planes (hi, lo) of every tile.
template <int HD, bool kSplit>
struct Geo {
  static constexpr int kHDP = HD == 112 ? 128 : HD;
  static constexpr int kCol = kHDP < 64 ? kHDP : 64;   // one TMA box wide
  static constexpr int kChunks = kHDP / kCol;
  static constexpr int kRow = 2 * kCol;                // bytes: the swizzle
  static constexpr hopper::Swizzle kSwz = hopper::swizzle_for_row(kRow);
  static constexpr int kParts = kSplit ? 2 : 1;
  static constexpr int kQChunk = kBQ * kRow;
  static constexpr int kKVChunk = kBKV * kRow;
  static constexpr int kQBytes = kChunks * kQChunk;    // one plane
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one plane of K or V
  static constexpr int kStageBytes = 2 * kParts * kKVBytes;  // K, then V
  static constexpr int kStages = kSplit && HD == 192 ? 1 : 2;
  static constexpr int kSmem = kParts * kQBytes + kStages * kStageBytes +
                               (1 + 2 * kStages) * 8 + 1024;
};

// O (m64 x N) += P (registers) . V (MN-major smem), N columns of V
// (scale_d = 0: O = P . V)
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t (&p)[4], uint64_t v,
                                         int scale_d = 1) {
  using namespace hopper;
  if constexpr (N == 16) wgmma_m64n16k16_rs<1>(o, p, v, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16_rs<1>(o, p, v, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_rs<1>(o, p, v, scale_d);
  else if constexpr (N == 128) wgmma_m64n128k16_rs<1>(o, p, v, scale_d);
  else wgmma_m64n192k16_rs<1>(o, p, v, scale_d);
}

// The split path's O (m64 x N) += P_hi.V_hi + P_lo.V_hi + P_hi.V_lo over
// a 64-key tile, V's hi and lo planes at va and va + kKVBytes; scale0 = 0:
// the first product overwrites acc.
template <typename G, int N>
__device__ __forceinline__ void pv_split(float (&acc)[N / 2],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         uint32_t va, int scale0) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = va + kk * 16 * G::kRow;
    const uint64_t vh = make_desc(at, G::kKVChunk, 8 * G::kRow, G::kSwz);
    const uint64_t vl =
        make_desc(at + G::kKVBytes, G::kKVChunk, 8 * G::kRow, G::kSwz);
    wgmma_pv<N>(acc, ph[kk], vh, kk > 0 || scale0);
    wgmma_pv<N>(acc, pl[kk], vh);
    wgmma_pv<N>(acc, ph[kk], vl);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// Key tiles [lo, hi) that hold an unmasked key for some of the 64 query
// rows from r0; lo == hi: none.
__device__ __forceinline__ void key_tiles(const Args& p, int r0, int nk,
                                          int& lo, int& hi) {
  if (r0 >= p.Sq) {
    lo = hi = 0;
    return;
  }
  const int r_last = min(r0 + 64, p.Sq) - 1;
  hi = p.causal ? min(nk, r_last / kBKV + 1) : nk;
  lo = p.window > 0 ? max(0, r0 - p.window + 1) / kBKV : 0;
  if (lo > hi) lo = hi;
}

template <int HD, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, Args p) {
  using namespace hopper;
  using G = Geo<HD, kSplit>;
  constexpr int N = G::kHDP;
  constexpr int kStages = G::kStages;
  // the split path promotes P.V's sums where a partial fits beside O (the
  // source note says why and where)
  constexpr bool kPromote = kSplit && N <= 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                 // plane part at part * kQBytes
  // stage s at s * kStageBytes: the K planes, then the V planes
  uint8_t* kv = smem + G::kParts * G::kQBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + kStages * G::kStageBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int kvh = h / (p.H / p.KV);
  const int nk = (p.Sk + kBKV - 1) / kBKV;
  int lo[2], hi[2];
  key_tiles(p, q0, nk, lo[0], hi[0]);
  key_tiles(p, q0 + 64, nk, lo[1], hi[1]);
  // the CTA's tiles: the union of both halves' ranges (they overlap or
  // touch: the second half's first tile is at most one past the first
  // half's last)
  int first = nk, last = 0;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (hi[w] > lo[w]) {
      first = min(first, lo[w]);
      last = max(last, hi[w]);
    }
  }
  const int n = max(0, last - first);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);         // one arrival per consumer group
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: Q once, then K and V tiles through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, G::kParts * G::kQBytes);
#pragma unroll
      for (int part = 0; part < G::kParts; ++part)
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c)
          tma_load_4d(qs + part * G::kQBytes + c * G::kQChunk, &tq, qbar,
                      c * G::kCol, q0, h, b + part * p.B);
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int k0 = (first + it) * kBKV;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], G::kStageBytes);
        uint8_t* ks = kv + s * G::kStageBytes;
#pragma unroll
        for (int part = 0; part < G::kParts; ++part)
#pragma unroll
          for (int c = 0; c < G::kChunks; ++c) {
            tma_load_4d(ks + part * G::kKVBytes + c * G::kKVChunk, &tk,
                        &full[s], c * G::kCol, k0, kvh, b + part * p.B);
            tma_load_4d(ks + (G::kParts + part) * G::kKVBytes +
                            c * G::kKVChunk,
                        &tv, &full[s], c * G::kCol, k0, kvh,
                        b + part * p.B);
          }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread rows r0 and r0 + 8, key columns 8j + cq + {0, 1} of each tile
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const int my_lo = wg ? lo[1] : lo[0];
  const int my_hi = wg ? hi[1] : hi[0];
  const bool capped = p.softcap > 0.f;
  // scores go to the log2 domain before the mask, so exp2 gives exp
  const float sc = capped ? p.scale : p.scale * kLog2e;
  const uint32_t qa = smem_u32(qs) + wg * 64 * G::kRow;

  float o[N / 2], s[32];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % kStages;
    const int kt = first + it;
    mbar_wait(&full[st], (it / kStages) & 1);
    if (kt >= my_lo && kt < my_hi) {
      const uint32_t ka = smem_u32(kv + st * G::kStageBytes);
      const uint32_t va = ka + G::kParts * G::kKVBytes;
      // S = Q . K^T, both K-major (split: Q_hi.K_hi, Q_hi.K_lo, Q_lo.K_hi)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int c = kk / (G::kCol / 16);
        const int off = (kk % (G::kCol / 16)) * 32;
        const uint32_t qoff = c * G::kQChunk + off;
        const uint32_t koff = c * G::kKVChunk + off;
        const uint64_t qd = make_desc(qa + qoff, 16, 8 * G::kRow, G::kSwz);
        const uint64_t kd = make_desc(ka + koff, 16, 8 * G::kRow, G::kSwz);
        wgmma_m64n64k16_ss<0>(s, qd, kd, kk > 0);
        if constexpr (kSplit) {
          wgmma_m64n64k16_ss<0>(
              s, qd,
              make_desc(ka + G::kKVBytes + koff, 16, 8 * G::kRow, G::kSwz),
              1);
          wgmma_m64n64k16_ss<0>(
              s, make_desc(qa + G::kQBytes + qoff, 16, 8 * G::kRow, G::kSwz),
              kd, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();

      // scale, softcap and mask on the fragments; row max over the quad
      const int k0 = kt * kBKV;
      const int rmin = q0 + wg * 64;
      const bool edge = (p.causal && k0 + kBKV - 1 > rmin) ||
                        (p.window > 0 && k0 <= rmin + 63 - p.window) ||
                        k0 + kBKV > p.Sk;
      float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * j + e] * sc;
          float x1 = s[4 * j + 2 + e] * sc;
          if (capped) {
            x0 = p.softcap * tanhf(x0 / p.softcap) * kLog2e;
            x1 = p.softcap * tanhf(x1 / p.softcap) * kLog2e;
          }
          if (edge) {
            const int kj = k0 + 8 * j + cq + e;
            bool keep0 = true, keep1 = true;
            if (p.causal) {
              keep0 = kj <= r0;
              keep1 = kj <= r1;
            }
            if (p.window > 0) {
              keep0 = keep0 && kj > r0 - p.window;
              keep1 = keep1 && kj > r1 - p.window;
            }
            x0 = keep0 ? x0 : kMasked;
            x1 = keep1 ? x1 : kMasked;
            if (kj >= p.Sk) x0 = x1 = -INFINITY;   // past the keys: adds 0
          }
          s[4 * j + e] = x0;
          s[4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0);
      const float n1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - n0);
      const float a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - n0);
          s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - n1);
          rs0 += s[4 * j + e];
          rs1 += s[4 * j + 2 + e];
        }
      }
      // this thread's share of each row's denominator: alpha is the same
      // in the four threads of a row, so the shares add up at the end
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      if constexpr (!kPromote) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
      }

      // O += P . V: P as the register A operand (keys 16 kk ..), V
      // MN-major (hd contiguous); bf16: P rounded; split: P_hi.V_hi,
      // P_lo.V_hi, P_hi.V_lo, and where kPromote, into a fresh `part`
      // that then gives O = fma(alpha, O, part) on the CUDA cores
      if constexpr (kSplit) {
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                   pl[kk][i]);
        if constexpr (kPromote) {
          float part[N / 2];
          pv_split<G, N>(part, ph, pl, va, 0);
#pragma unroll
          for (int i = 0; i < N / 2; ++i)
            o[i] = fmaf(i % 4 < 2 ? a0 : a1, o[i], part[i]);
        } else {
          pv_split<G, N>(o, ph, pl, va, 1);
        }
      } else {
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_pv<N>(o, pa[kk],
                      make_desc(va + kk * 16 * G::kRow, G::kKVChunk,
                                8 * G::kRow, G::kSwz));
        wgmma_commit();
        wgmma_wait<0>();
      }
    }
    if (t == 0) mbar_arrive(&empty[st]);   // every tile, used or skipped
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int64_t base = b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= HD) continue;             // hd % 8 == 0: pairs stay whole
    if constexpr (kSplit) {
      float* ob = static_cast<float*>(p.o) + base;
      if (r0 < p.Sq)
        *reinterpret_cast<float2*>(ob + r0 * p.os[2] + col) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<float2*>(ob + r1 * p.os[2] + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + base;
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * p.os[2] + col) =
            pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * p.os[2] + col) =
            pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// dims: the maps' batch (B, or 2B for the split path's planes), H, KV, Sq,
// Sk, hd; strides: element strides of (b, h, s) of the bf16 q, k, v the
// maps read.
template <int HD, bool kSplit>
int launch(const void* q, const void* k, const void* v, const int64_t* dims,
           const int64_t* strides, const Args& args, cudaStream_t stream) {
  using namespace hopper;
  using G = Geo<HD, kSplit>;
  // 4D maps over (hd, S, heads, batch) with the tensors' own strides, so
  // the model's (B, S, H, hd) tensors pass as transposed views
  auto map = [&](CUtensorMap* m, const void* base, int64_t S, int64_t heads,
                 const int64_t* st, uint32_t rows) {
    const uint64_t d[4] = {static_cast<uint64_t>(HD),
                           static_cast<uint64_t>(S),
                           static_cast<uint64_t>(heads),
                           static_cast<uint64_t>(dims[0])};
    const uint64_t bytes[3] = {static_cast<uint64_t>(2 * st[2]),
                               static_cast<uint64_t>(2 * st[1]),
                               static_cast<uint64_t>(2 * st[0])};
    const uint32_t box[4] = {static_cast<uint32_t>(G::kCol), rows, 1, 1};
    return encode_bf16_map(m, base, 4, d, bytes, box, G::kSwz);
  };
  CUtensorMap tq, tk, tv;
  int err = map(&tq, q, dims[3], dims[1], strides, kBQ);
  if (err == 0) err = map(&tk, k, dims[4], dims[2], strides + 3, kBKV);
  if (err == 0) err = map(&tv, v, dims[4], dims[2], strides + 6, kBKV);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<HD, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(args.H, static_cast<unsigned>(args.B),
                  (args.Sq + kBQ - 1) / kBQ);
  flash_wgmma<HD, kSplit><<<grid, kThreads, G::kSmem, stream>>>(tq, tk, tv,
                                                                args);
  return cudaGetLastError();
}

template <bool kSplit>
int dispatch_hd(int64_t hd, const void* q, const void* k, const void* v,
                const int64_t* dims, const int64_t* strides, const Args& a,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, kSplit>(q, k, v, dims, strides, a, s);
    case 32: return launch<32, kSplit>(q, k, v, dims, strides, a, s);
    case 64: return launch<64, kSplit>(q, k, v, dims, strides, a, s);
    case 112: return launch<112, kSplit>(q, k, v, dims, strides, a, s);
    case 128: return launch<128, kSplit>(q, k, v, dims, strides, a, s);
    case 192: return launch<192, kSplit>(q, k, v, dims, strides, a, s);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(void* o, const int64_t* dims, const int64_t* strides,
               int causal, int window, float softcap, float scale) {
  Args a;
  a.o = o;
  for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.KV = static_cast<int>(dims[2]);
  a.Sq = static_cast<int>(dims[3]);
  a.Sk = static_cast<int>(dims[4]);
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  return a;
}

}  // namespace tc

}  // namespace

// bf16 q, k, v, o. dims: B, H, KV, Sq, Sk, hd (hd in 16, 32, 64, 112, 128,
// 192). strides: element strides of (b, h, s) for q, k, v and o in that
// order; the last dim is contiguous and every stride but the last a
// multiple of 8 elements (16 bytes, TMA's rule; the wrapper checks).
// window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            const int64_t* dims,
                                            const int64_t* strides,
                                            int causal, int window,
                                            float softcap, float scale,
                                            void* stream) {
  const tc::Args a =
      tc::make_args(o, dims, strides, causal, window, softcap, scale);
  return tc::dispatch_hd<false>(dims[5], q, k, v, dims, strides, a,
                                static_cast<cudaStream_t>(stream));
}

// f32 q, k, v, o, dims and strides as above, every row 16-byte aligned and
// B * heads * S * hd below 2^31 for each of q, k and v; qs, ks, vs: bf16
// scratch of 2 * q.numel(), 2 * k.numel(), 2 * v.numel() elements, 16-byte
// aligned (the split pass writes them, the attention kernel reads them).
extern "C" int flash_attention_split_launch(const void* q, const void* k,
                                            const void* v, void* o, void* qs,
                                            void* ks, void* vs,
                                            const int64_t* dims,
                                            const int64_t* strides,
                                            int causal, int window,
                                            float softcap, float scale,
                                            void* stream) {
  const int64_t B = dims[0], H = dims[1], KV = dims[2], Sq = dims[3],
                Sk = dims[4], hd = dims[5];
  if (hd != 16 && hd != 32 && hd != 64 && hd != 112 && hd != 128 &&
      hd != 192)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SplitArgs sa;
  const void* src[3] = {q, k, v};
  void* dst[3] = {qs, ks, vs};
  const int64_t heads[3] = {H, KV, KV};
  const int64_t len[3] = {Sq, Sk, Sk};
  int64_t most = 0;
  for (int i = 0; i < 3; ++i) {
    sa.src[i] = static_cast<const float*>(src[i]);
    sa.dst[i] = static_cast<__nv_bfloat16*>(dst[i]);
    for (int j = 0; j < 3; ++j) sa.st[i][j] = strides[3 * i + j];
    sa.heads[i] = static_cast<int>(heads[i]);
    sa.S[i] = static_cast<int>(len[i]);
    most = std::max(most, B * heads[i] * len[i] * (hd / 8));
  }
  sa.B = static_cast<int>(B);
  sa.hd = static_cast<int>(hd);
  const int64_t blocks = (most + kSplitThreads - 1) / kSplitThreads;
  split_qkv<<<dim3(static_cast<unsigned>(std::min<int64_t>(blocks, 4096)), 3),
              kSplitThreads, 0, s>>>(sa);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the planes: contiguous (2B, heads, S, hd), hi at batches 0..B-1
  const int64_t pdims[6] = {2 * B, H, KV, Sq, Sk, hd};
  const int64_t pstrides[9] = {H * Sq * hd, Sq * hd, hd,
                               KV * Sk * hd, Sk * hd, hd,
                               KV * Sk * hd, Sk * hd, hd};
  const tc::Args a =
      tc::make_args(o, dims, strides, causal, window, softcap, scale);
  return tc::dispatch_hd<true>(hd, qs, ks, vs, pdims, pstrides, a, s);
}
