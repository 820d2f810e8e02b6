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
// Two kernels, chosen before launch from dtype alone (the wrapper's
// kernel_path):
//
// 1. bf16: `tc::flash_wgmma`, on the tensor cores (989 TFLOP/s dense
//    bf16; bound 0.069 ms at the qwen shape).
//    * One CTA per (head, batch, 128-query tile), the longest query tiles
//      first (the causal frontier makes late tiles the heaviest).
//    * Warp specialisation, 384 threads: a producer warpgroup (one thread
//      issues, 40 registers) loads the Q tile once and 64-key K and V tiles
//      into a two-stage ring, by TMA on 4D tensor maps over (hd, S, heads,
//      B) with the tensors' own strides (the model's (B, S, H, hd) tensors
//      pass as transposed views), one mbarrier a stage. Rows are cut into
//      chunks of the swizzle width: 64 columns with the 128-byte swizzle
//      (hd 112 is laid out as 128, TMA zero-filling the pad; hd 192 as
//      three chunks), hd 32 and 16 whole with the 64- and 32-byte swizzles.
//    * Two consumer warpgroups (232 registers) own 64 query rows each:
//      S = Q.K^T by wgmma m64n64k16 from shared memory (both K-major), then
//      scale, softcap, mask, row max and row sum on the accumulator's own
//      fragments in registers (a row lives in the four threads of a quad:
//      two shuffles), scores kept in the log2 domain so exp2 gives exp;
//      P is rounded to bf16 in registers and is the register A operand of
//      O += P.V (wgmma m64nNk16, N the padded hd; V is MN-major, hd
//      contiguous). O (up to 96 f32 a thread at hd 192) stays in registers
//      and is stored as bf16 pairs, masked to (Sq, hd).
//    * Each warpgroup skips the compute of key tiles outside its own 64
//      rows' range but still waits for and releases every stage.
//    P in bf16 is the one numerical difference from the TPU kernel, which
//    multiplies V by p in f32; it stays well inside the bf16 tolerance.
//    ptxas (nvcc 12.9): 168 registers at every hd (the 384-thread launch
//    bound; setmaxnreg: producer 40, consumers 232), no spills.
// 2. f32: `flash_fwd`, plain FMA on the CUDA cores (its ceiling is the
//    67 TFLOP/s f32 rate; TF32 would change the numbers). It keeps the FMA
//    pipes fed from shared memory:
//    * one CTA of 256 threads per (head, batch, 64-query tile); the query
//      tile is staged once, then 64-key K and V tiles in turn, all as f32
//      rows padded by 4 floats so the 16-byte reads below are conflict-free;
//    * thread (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i and
//      keys tx + 16 j (i, j < 4): each 16-byte read of Q and of K feeds 16
//      FMAs of its 4 x 4 score block; the 16 threads of a row sit in one
//      half-warp, so the row max is four shuffles;
//    * P goes through shared memory, and the same thread computes P.V for
//      its 4 rows over hd/16 output columns, one 16-byte read of P per 4
//      keys and row;
//    * the grid runs the longest query tiles first.
//    ptxas (nvcc 12.9): 116-158 registers, no spills.
//    It takes f32 only: flash_attention_launch refuses the bf16 tag.
// No atomics and a fixed order of every sum: results repeat bitwise.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or a tensor-map error, hopper.cuh); the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDP = kBK + 16;   // P row stride: the two half-warps' rows
                                 // land 16 banks apart
constexpr float kMasked = -1e30f;

// dtype tags shared with repro_torch/kernels/flash_attention.py; bf16
// goes to flash_attention_wgmma_launch
enum DType : int { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  int64_t qs[3], ks[3], vs[3], os[3];  // element strides of b, h, s
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no softcap
  float scale;
};

template <int HD>
constexpr int smem_floats() {
  return 3 * kBQ * (HD + 4) + kBQ * kLDP;
}

// Stage rows [row0, row0 + 64) of one (b, h) slice into dst as f32 rows of
// stride HD + 4; rows at or past `limit` are zeros. One shared-memory store
// per chunk, the load predicated: written as a branch with a store on each
// side, nvcc 12.9 keeps both stores and the kernel runs slower (PERF.md,
// PR 17).
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      int64_t row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + 4;
  // 16-byte chunks of a row: 4 f32
  constexpr int kPer = 4;
  constexpr int kChunks = HD / kPer;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kPer;
    float* d = dst + r * LD + col;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < limit)
      val = __ldg(reinterpret_cast<const float4*>(base + row * row_stride +
                                                  col));
    *reinterpret_cast<float4*>(d) = val;
  }
}

// Output columns a thread reads from one V row at a time: the widest of 4,
// 2, 1 that divides its DPT columns (hd 112 gives DPT 7: one at a time).
template <int DPT>
__host__ __device__ constexpr int vec_width() {
  return DPT % 4 == 0 ? 4 : DPT % 2 == 0 ? 2 : 1;
}

// The register budget: hd up to 128 asks for two CTAs an SM (128
// registers a thread); hd 192 holds 48 accumulators a thread and a CTA
// takes 171 KB of shared memory, so one CTA an SM and up to 255 registers.
template <int HD>
__host__ __device__ constexpr int min_blocks() {
  return HD <= 128 ? 2 : 1;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
    flash_fwd(Params p) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;              // output columns per thread
  constexpr int VW = vec_width<DPT>();      // ... read VW at a time
  constexpr int NV = DPT / VW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int kvh = h / (p.H / p.KV);

  const float* qb = static_cast<const float*>(p.q) + b * p.qs[0] +
                    h * p.qs[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.ks[0] +
                    kvh * p.ks[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.vs[0] +
                    kvh * p.vs[1];
  float* ob = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1];

  stage<HD>(Qs, qb, p.qs[2], q0, p.Sq);

  // key tiles that hold an unmasked key for some row of this query tile
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int nk = (p.Sk + kBK - 1) / kBK;
  const int kt_end = p.causal ? min(nk, q_last / kBK + 1) : nk;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kBK : 0;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    stage<HD>(Ks, kb, p.ks[2], k0, p.Sk);
    stage<HD>(Vs, vb, p.vs[2], k0, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = true;
        if (p.causal) keep = kj <= qi;
        if (p.window > 0) keep = keep && (kj > qi - p.window);
        x = keep ? x : kMasked;
        if (kj >= p.Sk) x = -INFINITY;    // past the keys: adds exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLDP + tx + 16 * j] = e;
        rs += e;
      }
      // this thread's share of the row's denominator: alpha is the same
      // in all 16 threads of the row, so the shares add up at the end
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * LD;
        float vals[DPT];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float* src = vrow + (tx + 16 * n) * VW;
          if constexpr (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vals[n * 4] = t.x;
            vals[n * 4 + 1] = t.y;
            vals[n * 4 + 2] = t.z;
            vals[n * 4 + 3] = t.w;
          } else if constexpr (VW == 2) {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vals[n * 2] = t.x;
            vals[n * 2 + 1] = t.y;
          } else {
            vals[n] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pj = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                         : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pj, vals[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = ob + qi * p.os[2];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[(tx + 16 * n) * VW + e] = acc[i][n * VW + e] * inv;
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(p, stream);
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 112: return launch<112>(p, stream);   // zamba2-7b's shared block
    case 128: return launch<128>(p, stream);
    case 192: return launch<192>(p, stream);   // nemotron-4-340b
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;           // query rows per CTA: two warpgroups of 64
constexpr int kBKV = 64;           // keys per tile
constexpr int kThreads = 384;      // consumers 0-255, producer 256-383
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  __nv_bfloat16* o;
  int64_t os[3];                   // element strides of o's b, h, s
  int H, KV, Sq, Sk;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no softcap
  float scale;
};

// Shared-memory geometry of one head dim. A tile's rows are cut into
// chunks of the swizzle width (64 columns, 128 bytes; hd 32 and 16 take
// the 64- and 32-byte swizzles whole); hd 112 is laid out as 128 columns,
// the last 16 zero-filled by TMA (the map's hd is 112).
template <int HD>
struct Geo {
  static constexpr int kHDP = HD == 112 ? 128 : HD;
  static constexpr int kCol = kHDP < 64 ? kHDP : 64;   // one TMA box wide
  static constexpr int kChunks = kHDP / kCol;
  static constexpr int kRow = 2 * kCol;                // bytes: the swizzle
  static constexpr hopper::Swizzle kSwz = hopper::swizzle_for_row(kRow);
  static constexpr int kQChunk = kBQ * kRow;
  static constexpr int kKVChunk = kBKV * kRow;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;     // K then V
  static constexpr int kSmem = kQBytes + 2 * kStageBytes + 5 * 8 + 1024;
};

// O (m64 x N) += P (registers) . V (MN-major smem), N = the padded hd
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t (&p)[4], uint64_t v) {
  using namespace hopper;
  if constexpr (N == 16) wgmma_m64n16k16_rs<1>(o, p, v, 1);
  else if constexpr (N == 32) wgmma_m64n32k16_rs<1>(o, p, v, 1);
  else if constexpr (N == 64) wgmma_m64n64k16_rs<1>(o, p, v, 1);
  else if constexpr (N == 128) wgmma_m64n128k16_rs<1>(o, p, v, 1);
  else wgmma_m64n192k16_rs<1>(o, p, v, 1);
}

// Key tiles [lo, hi) that hold an unmasked key for some of the 64 query
// rows from r0 (the FMA kernel's rule for its 64-row query tiles, so a
// fully masked row comes out as it does there); lo == hi: none.
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

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, Args p) {
  using namespace hopper;
  using G = Geo<HD>;
  constexpr int N = G::kHDP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* kv = smem + G::kQBytes;   // stage s: K at s * kStageBytes, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + 2 * G::kStageBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = qbar + 3;

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
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);         // one arrival per consumer group
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: Q once, then K and V tiles through a two-stage ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        tma_load_4d(qs + c * G::kQChunk, &tq, qbar, c * G::kCol, q0, h, b);
      for (int it = 0; it < n; ++it) {
        const int s = it & 1;
        const int k0 = (first + it) * kBKV;
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], G::kStageBytes);
        uint8_t* ks = kv + s * G::kStageBytes;
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load_4d(ks + c * G::kKVChunk, &tk, &full[s], c * G::kCol, k0,
                      kvh, b);
          tma_load_4d(ks + G::kKVBytes + c * G::kKVChunk, &tv, &full[s],
                      c * G::kCol, k0, kvh, b);
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
    const int st = it & 1;
    const int kt = first + it;
    mbar_wait(&full[st], (it >> 1) & 1);
    if (kt >= my_lo && kt < my_hi) {
      const uint32_t ka = smem_u32(kv + st * G::kStageBytes);
      const uint32_t va = ka + G::kKVBytes;
      // S = Q . K^T, both K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int c = kk / (G::kCol / 16);
        const int off = (kk % (G::kCol / 16)) * 32;
        wgmma_m64n64k16_ss<0>(
            s, make_desc(qa + c * G::kQChunk + off, 16, 8 * G::kRow, G::kSwz),
            make_desc(ka + c * G::kKVChunk + off, 16, 8 * G::kRow, G::kSwz),
            kk > 0);
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
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P . V: P in bf16 as the register A operand (keys 16 kk ..),
      // V MN-major (hd contiguous)
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
    if (t == 0) mbar_arrive(&empty[st]);   // every tile, used or skipped
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= HD) continue;             // hd % 8 == 0: pairs stay whole
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.os[2] + col) =
          pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.os[2] + col) =
          pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int64_t* dims,
           const int64_t* strides, const Args& args, cudaStream_t stream) {
  using namespace hopper;
  using G = Geo<HD>;
  // 4D maps over (hd, S, heads, B) with the tensors' own strides, so the
  // model's (B, S, H, hd) tensors pass as transposed views
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
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(args.H, static_cast<unsigned>(dims[0]),
                  (args.Sq + kBQ - 1) / kBQ);
  flash_wgmma<HD><<<grid, kThreads, G::kSmem, stream>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dims: B, H, KV, Sq, Sk, hd. strides: element strides of (b, h, s) for q,
// k, v and o in that order; the last dim is contiguous and every row starts
// 16-byte aligned (the wrapper checks). window <= 0 and softcap <= 0 mean
// none. dtype: kF32 only; any other tag returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* dims,
                                      const int64_t* strides, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.KV = static_cast<int>(dims[2]);
  p.Sq = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  const int hd = static_cast<int>(dims[5]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_hd(hd, p, s);
    default: return cudaErrorInvalidValue;   // bf16 takes the wgmma entry
  }
}

// bf16 q, k, v, o; dims, strides, causal, window, softcap and scale as for
// flash_attention_launch, and every stride but the last a multiple of 8
// elements (16 bytes, TMA's rule; the wrapper checks).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            const int64_t* dims,
                                            const int64_t* strides,
                                            int causal, int window,
                                            float softcap, float scale,
                                            void* stream) {
  tc::Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
  a.H = static_cast<int>(dims[1]);
  a.KV = static_cast<int>(dims[2]);
  a.Sq = static_cast<int>(dims[3]);
  a.Sk = static_cast<int>(dims[4]);
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 16: return tc::launch<16>(q, k, v, dims, strides, a, s);
    case 32: return tc::launch<32>(q, k, v, dims, strides, a, s);
    case 64: return tc::launch<64>(q, k, v, dims, strides, a, s);
    case 112: return tc::launch<112>(q, k, v, dims, strides, a, s);
    case 128: return tc::launch<128>(q, k, v, dims, strides, a, s);
    case 192: return tc::launch<192>(q, k, v, dims, strides, a, s);
    default: return cudaErrorInvalidValue;
  }
}
