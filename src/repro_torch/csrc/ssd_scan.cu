// Mamba2 SSD chunked scan on Hopper (state-space duality, arXiv:2405.21060
// section 6): per (batch, head), inside each chunk of Q steps,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//         + exp(cs_i) C_i . S_prev + D x_i,
// with cs the within-chunk cumsum of dt*A, and an (N, P) f32 state carried
// from chunk to chunk:
//   S = exp(cs_last) S_prev + sum_j exp(cs_last - cs_j) dt_j B_j x_j^T.
//
// Replaces src/repro/kernels/ssd_scan.py:87 (the Pallas TPU kernel
// `ssd_scan` and its `_kernel`), which the reference's model-layout adapter
// kernels/ops.py::ssd_scan reaches. The TPU kernel walked a (B*H, S/Q) grid
// with the chunk axis sequential and the state in VMEM scratch, and its
// wrapper copied x, dt, b and c into a per-(batch, head) layout, b and c
// broadcast to every head. Neither carries over: Hopper blocks run in
// parallel and carry nothing, so the scan runs as the passes of the
// chunked algorithm itself, all on the caller's stream:
//   1. chunk_state: one CTA per (chunk, head, batch) takes the chunk's
//      cumsum of dt*A (warp shuffles, into a scratch `cs` (B, H, NC, Q))
//      and its own state sum_j exp(cs_last - cs_j) dt_j B_j x_j^T into a
//      scratch `states` (B, H, NC, N, P);
//   2. scores: C.B^T once per (batch, chunk) for all heads (n_groups is 1:
//      the heads share B and C), on the causal 64 x 64 tiles only, in f32,
//      into a scratch `cb` (B, NC, Q, Q) (8.4 MB at the mamba2-780m
//      prefill, which stays in the 50 MB L2 while the heads read it);
//   3. state_pass: one thread per 4 state elements of a (head, batch)
//      walks the chunks in order (the loads of 16 chunks issued together),
//      replaces each chunk's own state by the state that enters it, and
//      writes the final state;
//   4. chunk_output: one CTA per (64-row query tile, chunk, batch*head)
//      computes its rows' y: the inter-chunk term exp(cs_i) C_i . S_prev,
//      then for each 64-key tile up to the diagonal the gate
//      exp(cs_i - cs_j) dt_j (C.B^T)_ij and its product with x, then the D
//      skip, and stores y in x's dtype. Heads differ in A, dt and x only:
//      they share C.B^T, never the gate. The grid runs the longest (last)
//      query tiles of a chunk first.
// The model's tensors are read in place: x (B, S, H, P) and b/c (B, S, N)
// through their batch and step strides (the model passes slices of one
// projection), b and c once per batch, never copied per head. The ragged
// last chunk is masked, not padded: steps past S count as dt = 0, which
// leaves the state unchanged, as the reference's zero padding does.
//
// exp overflow: cs falls along a chunk, so cs_i - cs_j > 0 for j > i and
// exp of it may be inf. The gate selects (i >= j) before taking the
// exponent, never inf * 0; every exponent the kernel takes is <= 0.
//
// What bounds it: operations. At the mamba2-780m prefill (B 2, S 4096,
// H 48, P 64, N 128, Q 256) the algorithm needs ~19.6 GFLOP (C.B^T once per
// batch and chunk, the causal half only) against ~214 MB moved in f32:
// 0.29 ms at the card's f32 rate outside the tensor cores, 0.064 ms for the
// bytes; in bf16 the tensor cores' rate makes the bytes (107 MB) the bound.
//
// Two paths, chosen before launch from shapes and dtype (the wrapper's
// kernel_path); neither falls back to the other:
//
// 1. "fma" (f32, and bf16 shapes the other path does not take): f32 on the
//    CUDA cores; TF32 would not keep the f32 tolerance. Every product
//    (C.B^T, gate . x, C . S_prev) runs as 64 x 64 output tiles of 128
//    threads, thread (ty, tx) of an 8 x 16 layout owning rows 8 ty + r
//    (r < 8) and columns 4 tx + c (c < 4): for every 4 steps of the sum it
//    reads 8 float4 of the A tile (rows, stride 68 floats) and 4 float4 of
//    the B tile, 12 shared loads for 128 fmafs. The chunk state takes 256
//    threads, each 4 x ceil(N/64) state rows by 4 columns, 1 + N/64 float4
//    loads for 16 N/64 fmafs a step. bf16 inputs are widened as staged.
// 2. "wgmma" (bf16, Q a multiple of 64, P and N multiples of 16): every
//    product on bf16 wgmma m64n64k16 with f32 accumulators, one warpgroup
//    a CTA. Operands arrive by cp.async (16 bytes a copy, from the
//    16-byte-aligned rows the wrapper passes) in 128-byte-swizzled tiles,
//    the next key tile's while the current one computes:
//      C.B^T: C and B tiles both K-major (N contiguous), as stored;
//      gate . x: the gate from registers (A fragments), x MN-major;
//      C . S_prev: C K-major, S_prev MN-major (P contiguous), S_prev
//        split by state_pass into a bf16 scratch `sprev`;
//      the state, as S^T = (w o x)^T . B: (w o x)^T built from the landed
//        x tile (K-major), B MN-major.
//    A product of two bf16 values is exact in f32. The f32 operands (the
//    gate, S_prev and w o x) are split into two bf16 values, hi = bf16(v)
//    and lo = bf16(v - hi), and each product runs twice (hi, then lo) into
//    the same accumulator: |v - hi - lo| <= 2^-18 |v|, so the path keeps
//    the f32 path's accuracy, where rounding v to bf16 (2^-9) or TF32
//    (2^-11) would not meet the bf16 tolerance's 5e-4 floor on outputs
//    near 0.
// No atomics and a fixed order of every sum: results repeat bitwise.
//
// The scores' place was a design choice: this scratch pass, or (measured
// and dropped, PERF.md) one CTA per (query tile, chunk, batch, group of 8
// heads) that computed its 64-row strip of C.B^T into shared memory and
// looped over the group's heads; the strip ran 1.6-1.8x slower at the
// mamba2-780m and zamba2-7b prefill shapes (fewer, longer CTAs, one a SM).
//
// The C entry point allocates nothing (the Python wrapper passes the
// scratch buffers) and returns the first CUDA error of its launches; the
// wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;          // query rows, keys, state rows a tile
constexpr int kMaxP = 64;          // head_dim the kernel takes
constexpr int kMaxN = 256;         // d_state the kernel takes
constexpr int kJ = 32;             // steps staged at a time (chunk_state)
constexpr int kLD = kTile + 4;     // row stride of an f32 tile (fma path)
constexpr int kFmaThreads = 128;   // 8 x 16, 8 x 4 outputs a thread
constexpr int kStateThreads = 256; // 16 x 16
constexpr int kWgThreads = 128;    // one warpgroup
constexpr int kTileBytes = kTile * 128;  // 64 bf16 rows of 128 bytes

// tags shared with repro_torch/kernels/ssd_scan.py
enum DType : int { kF32 = 0, kBF16 = 1 };
enum Path : int { kFma = 0, kWgmma = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the hi/lo split of f32 operands (hopper.cuh), shared with the f32 paths
// of moe_gmm.cu and flash_attention.cu
using hopper::split2;
using hopper::split8;

struct Params {
  const void* x;         // (B, S, H, P), strides (x_sb, x_ss, P, 1)
  const float* dt;       // (B, S, H) contiguous
  const float* A;        // (H,)
  const void* b;         // (B, S, N), strides (b_sb, b_ss, 1)
  const void* c;         // (B, S, N), strides (c_sb, c_ss, 1)
  const float* D;        // (H,)
  void* y;               // (B, S, H, P) contiguous, x's dtype
  float* final_state;    // (B, H, N, P)
  float* cs;             // scratch (B, H, NC, Q)
  float* states;         // scratch (B, H, NC, N, P)
  float* cb;             // scratch (B, NC, Q, Q)
  __nv_bfloat16* sprev;  // scratch (B, H, NC, 2, N, P), path kWgmma
  int B, S, H, P, N, Q, NC;
  int64_t x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ int valid_steps(const Params& p, int ch) {
  return min(p.Q, p.S - ch * p.Q);
}

// Warp 0 only: cs[i] = sum_{k <= i} dt_k A_h over the chunk's Q steps
// (steps past S add 0), into shared `cs` and the scratch.
__device__ __forceinline__ void chunk_cumsum(const Params& p, int bb, int h,
                                             int ch, float* cs) {
  const int lane = threadIdx.x;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  float* cs_out = p.cs + (bh * p.NC + ch) * p.Q;
  const float a = p.A[h];
  float carry = 0.f;
  for (int base = 0; base < p.Q; base += 32) {
    const int i = base + lane;
    float v = i < nvalid
        ? p.dt[(static_cast<int64_t>(bb) * p.S + s0 + i) * p.H + h] * a
        : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (i < p.Q) {
      cs[i] = v;
      cs_out[i] = v;
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// ---------------------------------------------------------------------------
// path "fma": f32 on the CUDA cores
// ---------------------------------------------------------------------------

// acc[r][c] += sum_{k < kmax} a[(8 ty + r) kLD + k] b[k kLD + 4 tx + c]: a
// 64 x 64 output tile of an A tile (64 rows) and a B tile (k rows), both
// f32 with row stride kLD; kmax is a multiple of 4 (the tiles hold zeros
// past their real steps).
__device__ __forceinline__ void fma_tile(float (&acc)[8][4],
                                         const float* a, const float* b,
                                         int kmax) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < kmax; k += 4) {
    float4 av[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (8 * ty + r) * kLD + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + (k + u) * kLD + 4 * tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float ar = u == 0 ? av[r].x : u == 1 ? av[r].y
                         : u == 2 ? av[r].z : av[r].w;
        acc[r][0] = fmaf(ar, bv.x, acc[r][0]);
        acc[r][1] = fmaf(ar, bv.y, acc[r][1]);
        acc[r][2] = fmaf(ar, bv.z, acc[r][2]);
        acc[r][3] = fmaf(ar, bv.w, acc[r][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Pass 2: one 64 x 64 scores tile C_i . B_j (query tile blockIdx.x, key
// tile blockIdx.y <= it, batch*chunk blockIdx.z) into the scratch, the N
// sum in 64-wide steps through the shared tiles as (C rows) and bs (B^T).
template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
scores_fma(Params p) {
  __shared__ __align__(16) float as[kTile * kLD];
  __shared__ __align__(16) float bs[kTile * kLD];
  const int it = blockIdx.x, jt = blockIdx.y;
  const int bb = blockIdx.z / p.NC, ch = blockIdx.z % p.NC;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int i0 = it * kTile, j0 = jt * kTile;
  if (jt > it || i0 >= nvalid) return;   // never read
  const int ni = min(kTile, nvalid - i0), nj = min(kTile, nvalid - j0);
  const T* csrc = static_cast<const T*>(p.c) + bb * p.c_sb;
  const T* bsrc = static_cast<const T*>(p.b) + bb * p.b_sb;
  float acc[8][4];
  zero(acc);
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int nn = min(kTile, p.N - n0);
    // every load of the step issued before the first store
#pragma unroll
    for (int u = 0; u < kTile * kTile / kFmaThreads; ++u) {
      const int e = threadIdx.x + u * kFmaThreads;
      const int r = e / kTile, k = e % kTile;
      as[r * kLD + k] = r < ni && k < nn
          ? to_f32(csrc[(s0 + i0 + r) * p.c_ss + n0 + k]) : 0.f;
      bs[k * kLD + r] = r < nj && k < nn
          ? to_f32(bsrc[(s0 + j0 + r) * p.b_ss + n0 + k]) : 0.f;
    }
    __syncthreads();
    fma_tile(acc, as, bs, (nn + 3) & ~3);
    __syncthreads();
  }
  float* out = p.cb + (static_cast<int64_t>(blockIdx.z) * p.Q + i0) * p.Q
               + j0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (8 * ty + r >= ni) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < nj) out[(8 * ty + r) * p.Q + 4 * tx + c] = acc[r][c];
  }
}

// Pass 1: the chunk's cumsum of dt*A and its own state. NA = ceil(N / 64);
// thread (tn, tp) owns state rows n = 64 a + 4 tn + u (a < NA, u < 4) and
// columns p = 4 tp + v (v < 4).
template <typename T, int NA>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_fma(Params p) {
  constexpr int kLDB = kTile * NA;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                   // [kJ][kLDB]  B rows, zero past N
  float* xs = bs + kJ * kLDB;         // [kJ][kMaxP] x scaled by the weight
  float* ws = xs + kJ * kMaxP;        // [kJ] exp(cs_last - cs_j) dt_j
  float* cs = ws + kJ;                // [Q]
  const int ch = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  if (tid < 32) chunk_cumsum(p, bb, h, ch, cs);
  __syncthreads();
  const float cs_last = cs[p.Q - 1];

  const T* xb = static_cast<const T*>(p.x) + bb * p.x_sb +
                static_cast<int64_t>(h) * p.P;
  const T* bsrc = static_cast<const T*>(p.b) + bb * p.b_sb;
  const float* dtb = p.dt + static_cast<int64_t>(bb) * p.S * p.H + h;
  const int tn = tid / 16, tp = tid % 16;
  float acc[4 * NA][4];
#pragma unroll
  for (int a = 0; a < 4 * NA; ++a)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[a][v] = 0.f;

  for (int j0 = 0; j0 < nvalid; j0 += kJ) {
    const int jn = min(kJ, nvalid - j0);
    if (tid < jn)
      ws[tid] = expf(cs_last - cs[j0 + tid]) *
                dtb[static_cast<int64_t>(s0 + j0 + tid) * p.H];
    __syncthreads();
    for (int e = tid; e < kJ * kLDB; e += kStateThreads) {
      const int jj = e / kLDB, n = e % kLDB;
      bs[e] = jj < jn && n < p.N
          ? to_f32(bsrc[(s0 + j0 + jj) * p.b_ss + n]) : 0.f;
    }
    for (int e = tid; e < kJ * kMaxP; e += kStateThreads) {
      const int jj = e / kMaxP, q = e % kMaxP;
      xs[e] = jj < jn && q < p.P
          ? ws[jj] * to_f32(xb[(s0 + j0 + jj) * p.x_ss + q]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + jj * kMaxP + 4 * tp);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bs + jj * kLDB + kTile * a + 4 * tn);
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[4 * a + u][0] = fmaf(b4[u], xv.x, acc[4 * a + u][0]);
          acc[4 * a + u][1] = fmaf(b4[u], xv.y, acc[4 * a + u][1]);
          acc[4 * a + u][2] = fmaf(b4[u], xv.z, acc[4 * a + u][2]);
          acc[4 * a + u][3] = fmaf(b4[u], xv.w, acc[4 * a + u][3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = p.states + (bh * p.NC + ch) * p.N * p.P;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = kTile * a + 4 * tn + u;
      if (n >= p.N) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = 4 * tp + v;
        if (q < p.P) out[n * p.P + q] = acc[4 * a + u][v];
      }
    }
}

// Pass 3: one thread per V state elements walks the chunks in order and
// replaces each chunk's own state by the state that enters it: in place in
// f32 (the FMA path), or (kSplit, the wgmma path) as the bf16 pair hi, lo
// into the scratch `sprev` (B, H, NC, 2, N, P): the MN-major operand rows
// that chunk_output copies as they are. The loads of kPassBatch chunks go
// out before their stores, so the walk waits on device memory once a
// batch, not once a chunk.
constexpr int kPassBatch = 16;

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V, bool kSplit>
__global__ void __launch_bounds__(kStateThreads)
state_pass(Params p) {
  const int np = p.N * p.P;
  const int e = (blockIdx.x * kStateThreads + threadIdx.x) * V;
  const int h = blockIdx.y, bb = blockIdx.z;
  if (e >= np) return;
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  float* slot = p.states + bh * p.NC * np + e;
  const float* cs_last = p.cs + bh * p.NC * p.Q + p.Q - 1;
  float st[V];
#pragma unroll
  for (int v = 0; v < V; ++v) st[v] = 0.f;
  for (int c0 = 0; c0 < p.NC; c0 += kPassBatch) {
    float own[kPassBatch][V], last[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < p.NC) {
        load_v<V>(slot + static_cast<int64_t>(c0 + u) * np, own[u]);
        last[u] = cs_last[static_cast<int64_t>(c0 + u) * p.Q];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u >= p.NC) continue;
      if constexpr (kSplit) {
        static_assert(V == 4, "the split writes 4 bf16 pairs a thread");
        uint32_t hi[2], lo[2];
        split2(st[0], st[1], hi[0], lo[0]);
        split2(st[2], st[3], hi[1], lo[1]);
        __nv_bfloat16* out = p.sprev + ((bh * p.NC + c0 + u) * 2) * np + e;
        *reinterpret_cast<uint2*>(out) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(out + np) = make_uint2(lo[0], lo[1]);
      } else {
        store_v<V>(slot + static_cast<int64_t>(c0 + u) * np, st);
      }
      const float decay = expf(last[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) st[v] = st[v] * decay + own[u][v];
    }
  }
  store_v<V>(p.final_state + bh * np + e, st);
}

// Pass 4: the y rows of one 64-step query tile of one chunk and head.
template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
chunk_output_fma(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                   // [kTile][kLD] C rows, then the gate
  float* bs = as + kTile * kLD;       // [kTile][kLD] S_prev rows, then x
  float* csi = bs + kTile * kLD;      // [kTile] cs of the query rows
  float* csj = csi + kTile;           // [kTile] cs of the keys
  float* dtj = csj + kTile;           // [kTile] dt of the keys
  const int n_tiles = (p.Q + kTile - 1) / kTile;
  const int it = n_tiles - 1 - blockIdx.x;      // longest tiles first
  const int ch = blockIdx.y;
  const int bb = blockIdx.z / p.H, h = blockIdx.z % p.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int i0 = it * kTile;
  if (i0 >= nvalid) return;           // a tile wholly past S
  const int ni = min(kTile, nvalid - i0);
  // the scores of row i0, key 0 of the chunk (row stride Q)
  const float* cb = p.cb +
      (static_cast<int64_t>(bb * p.NC + ch) * p.Q + i0) * p.Q;
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  const float* cs_g = p.cs + (bh * p.NC + ch) * p.Q;
  const T* xb = static_cast<const T*>(p.x) + bb * p.x_sb +
                static_cast<int64_t>(h) * p.P;
  const T* csrc = static_cast<const T*>(p.c) + bb * p.c_sb;
  const float* dtb = p.dt + static_cast<int64_t>(bb) * p.S * p.H + h;
  if (tid < kTile) csi[tid] = tid < ni ? cs_g[i0 + tid] : 0.f;

  float y[8][4];
  zero(y);
  if (ch > 0) {                       // chunk 0 enters with a zero state
    const float* sp = p.states + (bh * p.NC + ch) * p.N * p.P;
    for (int n0 = 0; n0 < p.N; n0 += kTile) {
      const int nn = min(kTile, p.N - n0);
      for (int e = tid; e < kTile * kTile; e += kFmaThreads) {
        const int r = e / kTile, k = e % kTile;
        as[r * kLD + k] = r < ni && k < nn
            ? to_f32(csrc[(s0 + i0 + r) * p.c_ss + n0 + k]) : 0.f;
        bs[r * kLD + k] = r < nn && k < p.P
            ? sp[(n0 + r) * p.P + k] : 0.f;
      }
      __syncthreads();
      fma_tile(y, as, bs, (nn + 3) & ~3);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float dec = expf(csi[8 * ty + r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) y[r][c] *= dec;
    }
  }

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    const int nj = min(kTile, nvalid - j0);
    for (int e = tid; e < kTile * kTile; e += kFmaThreads) {
      const int r = e / kTile, q = e % kTile;
      bs[r * kLD + q] = r < nj && q < p.P
          ? to_f32(xb[(s0 + j0 + r) * p.x_ss + q]) : 0.f;
    }
    if (tid < kTile) {
      csj[tid] = tid < nj ? cs_g[j0 + tid] : 0.f;
      dtj[tid] = tid < nj
          ? dtb[static_cast<int64_t>(s0 + j0 + tid) * p.H] : 0.f;
    }
    __syncthreads();
    // the gate: select i >= j (and real rows and keys) before the exponent
    for (int e = tid; e < kTile * kTile; e += kFmaThreads) {
      const int r = e / kTile, k = e % kTile;
      float g = 0.f;
      if (r < ni && k < nj && j0 + k <= i0 + r)
        g = expf(csi[r] - csj[k]) * dtj[k] * cb[r * p.Q + j0 + k];
      as[r * kLD + k] = g;
    }
    __syncthreads();
    fma_tile(y, as, bs, (nj + 3) & ~3);
    __syncthreads();
  }
  // bs now holds the x rows of the query tile (the last key tile was the
  // diagonal one): the D skip reads them.
  const float d = p.D[h];
  T* yb = static_cast<T*>(p.y);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = 8 * ty + r;
    if (row >= ni) continue;
    T* yrow = yb + ((static_cast<int64_t>(bb) * p.S + s0 + i0 + row) * p.H +
                    h) * p.P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 4 * tx + c;
      if (q < p.P) store1(yrow + q, y[r][c] + d * bs[row * kLD + q]);
    }
  }
}

// ---------------------------------------------------------------------------
// path "wgmma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Issue cp.async copies of rows [0, 64) of a bf16 matrix (row stride
// `stride` elements, `ncols` a multiple of 8, rows 16-byte aligned) into a
// tile of 128-byte swizzled rows: 16-byte chunk g of row r goes to chunk
// g % 8 of row r of column block g / 8 (kTileBytes apart). Rows at or past
// nrows arrive as zeros; columns past ncols are left unwritten. The caller
// commits and waits.
__device__ __forceinline__ void stage_rows(uint8_t* tile, const bf16* src,
                                           int64_t stride, int nrows,
                                           int ncols) {
  const int per_row = (ncols + 63) / 64 * 8;
  for (int e = threadIdx.x; e < kTile * per_row; e += kWgThreads) {
    const int r = e / per_row, g = e % per_row;
    if (8 * g >= ncols) continue;
    const bool full = r < nrows;
    hopper::cp_async16(
        tile + (g / 8) * kTileBytes + hopper::swizzle128(r, g % 8),
        full ? src + r * stride + 8 * g : src, full);
  }
}

// Waits for this thread's copies, makes them visible to wgmma, and meets
// the other threads.
__device__ __forceinline__ void copies_landed() {
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
}

// The bf16 at (row, col) of a swizzled tile of 128-byte rows, as f32.
__device__ __forceinline__ float tile_at(const uint8_t* tile, int row,
                                         int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + hopper::swizzle128(row, col / 8) + 2 * (col % 8)));
}

// Descriptors: a K-major tile (column block of k-step kk), and an
// MN-major tile of 128-byte rows along K (k-step kk: rows 16 kk ..).
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return hopper::make_desc(hopper::smem_u32(tile) + (kk / 4) * kTileBytes +
                               (kk % 4) * 32,
                           16, 1024, hopper::kSwizzle128);
}
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return hopper::make_desc(hopper::smem_u32(tile) + kk * 16 * 128,
                           kTileBytes, 1024, hopper::kSwizzle128);
}

// The fragment coordinates of thread t of the warpgroup (PTX ISA): rows
// r0 and r0 + 8 of the m64 tile, columns 8 j + cq + {0, 1}.
struct Frag {
  int r0, r1, cq;
  __device__ Frag() {
    const int t = threadIdx.x, lane = t % 32;
    r0 = 16 * (t / 32) + lane / 4;
    r1 = r0 + 8;
    cq = 2 * (lane % 4);
  }
};

// Pass 2 on the tensor cores, as scores_fma: C.B^T over N, both tiles
// K-major, stored as f32 pairs from the accumulator fragments.
__global__ void __launch_bounds__(kWgThreads)
scores_wgmma(Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ct = hopper::align_1024(smem_raw);
  const int blocks = (p.N + 63) / 64;
  uint8_t* bt = ct + blocks * kTileBytes;
  const int it = blockIdx.x, jt = blockIdx.y;
  const int bb = blockIdx.z / p.NC, ch = blockIdx.z % p.NC;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int i0 = it * kTile, j0 = jt * kTile;
  if (jt > it || i0 >= nvalid) return;
  const bf16* csrc = static_cast<const bf16*>(p.c) + bb * p.c_sb;
  const bf16* bsrc = static_cast<const bf16*>(p.b) + bb * p.b_sb;
  stage_rows(ct, csrc + (s0 + i0) * p.c_ss, p.c_ss, nvalid - i0, p.N);
  stage_rows(bt, bsrc + (s0 + j0) * p.b_ss, p.b_ss, nvalid - j0, p.N);
  hopper::cp_async_commit();
  copies_landed();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
  for (int kk = 0; kk < p.N / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(acc, desc_k(ct, kk), desc_k(bt, kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  float* out = p.cb + (static_cast<int64_t>(blockIdx.z) * p.Q + i0) * p.Q +
               j0;
  const Frag f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + f.cq;
    *reinterpret_cast<float2*>(out + f.r0 * p.Q + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + f.r1 * p.Q + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Pass 1 on the tensor cores: S^T (P x N) = sum_k (w_k x_k) B_k^T, in
// NB = ceil(N / 64) column blocks. Each 64-key tile of x and B arrives by
// cp.async into one of two buffers (MN-major, as stored) while the last
// tile computes; (w o x)^T is built from the landed x tile, split into hi
// and lo, as the K-major A operand (rows p, keys contiguous).
template <int NB>
__global__ void __launch_bounds__(kWgThreads)
chunk_state_wgmma(Params p) {
  constexpr int kBuf = (1 + NB) * kTileBytes;   // an x tile, NB B tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ahi = hopper::align_1024(smem_raw);
  uint8_t* alo = ahi + kTileBytes;
  uint8_t* buf = alo + kTileBytes;              // [2][kBuf]
  float* cs = reinterpret_cast<float*>(buf + 2 * kBuf);   // [Q]
  float* ws = cs + p.Q;                                    // [Q]
  const int ch = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int n_tiles = (nvalid + kTile - 1) / kTile;
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  const bf16* xb = static_cast<const bf16*>(p.x) + bb * p.x_sb +
                   static_cast<int64_t>(h) * p.P + s0 * p.x_ss;
  const bf16* bsrc = static_cast<const bf16*>(p.b) + bb * p.b_sb +
                     s0 * p.b_ss;
  const float* dtb = p.dt + static_cast<int64_t>(bb) * p.S * p.H + h;
  auto issue = [&](int k) {
    uint8_t* b = buf + (k & 1) * kBuf;
    const int j0 = k * kTile;
    stage_rows(b, xb + j0 * p.x_ss, p.x_ss, nvalid - j0, p.P);
    stage_rows(b + kTileBytes, bsrc + j0 * p.b_ss, p.b_ss, nvalid - j0,
               p.N);
    hopper::cp_async_commit();
  };
  issue(0);
  if (tid < 32) chunk_cumsum(p, bb, h, ch, cs);
  __syncthreads();
  const float cs_last = cs[p.Q - 1];
  for (int j = tid; j < n_tiles * kTile; j += kWgThreads)
    ws[j] = j < nvalid
        ? expf(cs_last - cs[j]) * dtb[static_cast<int64_t>(s0 + j) * p.H]
        : 0.f;

  float acc[NB][32];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {
      issue(k + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();                  // tile k (and ws) everywhere
    const uint8_t* xt = buf + (k & 1) * kBuf;
    const float* wk = ws + k * kTile;
    // item (column q of x, keys 8 g .. 8 g + 7)
    for (int e = tid; e < kTile * 8; e += kWgThreads) {
      const int q = e % kTile, g = e / kTile;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = wk[8 * g + u] * tile_at(xt, 8 * g + u, q);
      uint4 hi, lo;
      split8(v, hi, lo);
      *reinterpret_cast<uint4*>(ahi + hopper::swizzle128(q, g)) = hi;
      *reinterpret_cast<uint4*>(alo + hopper::swizzle128(q, g)) = lo;
    }
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::wgmma_fence();
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc_mn(xt + (1 + m) * kTileBytes, kk);
        hopper::wgmma_m64n64k16_ss<1>(acc[m], desc_k(ahi, kk), bd, 1);
        hopper::wgmma_m64n64k16_ss<1>(acc[m], desc_k(alo, kk), bd, 1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncthreads();                  // A and this buffer serve again
  }

  // S^T fragments: rows q (r0, r1), columns n
  float* out = p.states + (bh * p.NC + ch) * p.N * p.P;
  const Frag f;
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = kTile * m + 8 * j + f.cq + e;
        if (n >= p.N) continue;
        if (f.r0 < p.P) out[n * p.P + f.r0] = acc[m][4 * j + e];
        if (f.r1 < p.P) out[n * p.P + f.r1] = acc[m][4 * j + 2 + e];
      }
}

// Pass 4 on the tensor cores: the y rows of one 64-step query tile of one
// chunk and head. Key tile k + 1 arrives by cp.async while tile k
// computes, and the scores of tile k + 1 are loaded before tile k's
// product. The inter-chunk term exp(cs_i) C_i . S_prev runs beside the
// first tile in its own accumulator.
__global__ void __launch_bounds__(kWgThreads)
chunk_output_wgmma(Params p) {
  extern __shared__ uint8_t smem_raw[];
  const int blocks = (p.N + 63) / 64;
  uint8_t* ct = hopper::align_1024(smem_raw);   // [N / 64] K-major tiles:
                                                // C rows of the query tile
  uint8_t* shi = ct + blocks * kTileBytes;      // [N rows][128 B] MN-major:
  uint8_t* slo = shi + blocks * kTileBytes;     // S_prev hi, lo
  uint8_t* xt = slo + blocks * kTileBytes;      // [2][64 rows][128 B]
                                                // MN-major: x of key tiles
  float* csi = reinterpret_cast<float*>(xt + 2 * kTileBytes);   // [kTile]
  float* csj = csi + kTile;                                      // [2][kTile]
  float* dtj = csj + 2 * kTile;                                  // [2][kTile]
  const int it = p.Q / kTile - 1 - blockIdx.x;  // longest tiles first
  const int ch = blockIdx.y;
  const int bb = blockIdx.z / p.H, h = blockIdx.z % p.H;
  const int tid = threadIdx.x;
  const Frag f;
  const int s0 = ch * p.Q, nvalid = valid_steps(p, ch);
  const int i0 = it * kTile;
  if (i0 >= nvalid) return;
  const int ni = min(kTile, nvalid - i0);
  // the scores of row i0, key 0 of the chunk (row stride Q)
  const float* cb = p.cb +
      (static_cast<int64_t>(bb * p.NC + ch) * p.Q + i0) * p.Q;
  if (ch > 0)
    stage_rows(ct, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                       (s0 + i0) * p.c_ss, p.c_ss, ni, p.N);
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  const float* cs_g = p.cs + (bh * p.NC + ch) * p.Q;
  const bf16* xb = static_cast<const bf16*>(p.x) + bb * p.x_sb +
                   static_cast<int64_t>(h) * p.P + s0 * p.x_ss;
  const float* dtb = p.dt + static_cast<int64_t>(bb) * p.S * p.H + h;
  auto issue = [&](int k) {
    const int j0 = k * kTile, nj = min(kTile, nvalid - j0);
    stage_rows(xt + (k & 1) * kTileBytes, xb + j0 * p.x_ss, p.x_ss, nj,
               p.P);
    hopper::cp_async_commit();
    if (tid < kTile) {
      csj[(k & 1) * kTile + tid] = tid < nj ? cs_g[j0 + tid] : 0.f;
      dtj[(k & 1) * kTile + tid] =
          tid < nj ? dtb[static_cast<int64_t>(s0 + j0 + tid) * p.H] : 0.f;
    }
  };
  float2 cbv[16];                     // scores of a tile: rows r0, r1
  auto load_scores = [&](int k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k * kTile + 8 * j + f.cq;
      cbv[2 * j] = *reinterpret_cast<const float2*>(cb + f.r0 * p.Q + col);
      cbv[2 * j + 1] =
          *reinterpret_cast<const float2*>(cb + f.r1 * p.Q + col);
    }
  };
  if (tid < kTile) csi[tid] = cs_g[i0 + tid];
  if (ch > 0) {                       // S_prev hi and lo, MN-major
    const bf16* sp = p.sprev + ((bh * p.NC + ch) * 2) * p.N * p.P;
    for (int n0 = 0; n0 < p.N; n0 += kTile) {
      const int off = (n0 / kTile) * kTileBytes;
      stage_rows(shi + off, sp + n0 * p.P, p.P, p.N - n0, p.P);
      stage_rows(slo + off, sp + (p.N + n0) * p.P, p.P, p.N - n0, p.P);
    }
  }
  issue(0);
  load_scores(0);
  float y[32], yi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = yi[i] = 0.f;
  copies_landed();                    // C rows, S_prev, key tile 0
  if (ch > 0) {
    hopper::wgmma_fence();
    for (int kk = 0; kk < p.N / 16; ++kk) {
      const uint64_t cd = desc_k(ct, kk);
      hopper::wgmma_m64n64k16_ss<1>(yi, cd, desc_mn(shi, kk), 1);
      hopper::wgmma_m64n64k16_ss<1>(yi, cd, desc_mn(slo, kk), 1);
    }
    hopper::wgmma_commit();
  }

  for (int k = 0; k <= it; ++k) {
    if (k < it) issue(k + 1);
    // the gate on the fragments: select i >= j (and real rows and keys)
    // before the exponent
    const int j0 = k * kTile, nj = min(kTile, nvalid - j0);
    const float* csk = csj + (k & 1) * kTile;
    const float* dtk = dtj + (k & 1) * kTile;
    const float ci0 = csi[f.r0], ci1 = csi[f.r1];
    float g[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * j + f.cq + e;
        const float w = dtk[kk], cj = csk[kk];
        const bool ok = kk < nj;
        const float v0 = e ? cbv[2 * j].y : cbv[2 * j].x;
        const float v1 = e ? cbv[2 * j + 1].y : cbv[2 * j + 1].x;
        g[4 * j + e] = ok && f.r0 < ni && j0 + kk <= i0 + f.r0
            ? expf(ci0 - cj) * w * v0 : 0.f;
        g[4 * j + 2 + e] = ok && f.r1 < ni && j0 + kk <= i0 + f.r1
            ? expf(ci1 - cj) * w * v1 : 0.f;
      }
    }
    if (k < it) load_scores(k + 1);
    // A fragments of k-step kk (keys 16 kk ..): the accumulator layout's
    // blocks 2 kk and 2 kk + 1, as hi and lo
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split2(g[8 * kk + 2 * q], g[8 * kk + 2 * q + 1], ah[kk][q],
               al[kk][q]);
    const uint8_t* xk = xt + (k & 1) * kTileBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t xd = desc_mn(xk, kk);
      hopper::wgmma_m64n64k16_rs<1>(y, ah[kk], xd, 1);
      hopper::wgmma_m64n64k16_rs<1>(y, al[kk], xd, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    copies_landed();                  // tile k + 1; tile k's buffer free
  }
  const float e0 = expf(csi[f.r0]), e1 = expf(csi[f.r1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    y[4 * j] = fmaf(e0, yi[4 * j], y[4 * j]);
    y[4 * j + 1] = fmaf(e0, yi[4 * j + 1], y[4 * j + 1]);
    y[4 * j + 2] = fmaf(e1, yi[4 * j + 2], y[4 * j + 2]);
    y[4 * j + 3] = fmaf(e1, yi[4 * j + 3], y[4 * j + 3]);
  }
  // the last key tile holds the x rows of the query tile: the D skip
  const uint8_t* xq = xt + (it & 1) * kTileBytes;
  const float d = p.D[h];
  bf16* yb = static_cast<bf16*>(p.y);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = 8 * j + f.cq;
    if (q >= p.P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? f.r1 : f.r0;
      if (r >= ni) continue;
      *reinterpret_cast<uint32_t*>(
          yb + ((static_cast<int64_t>(bb) * p.S + s0 + i0 + r) * p.H + h) *
                   p.P + q) =
          hopper::pack_bf16x2(y[4 * j + 2 * half] + d * tile_at(xq, r, q),
                              y[4 * j + 2 * half + 1] +
                                  d * tile_at(xq, r, q + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using Kernel = void (*)(Params);

cudaError_t run(Kernel k, dim3 grid, int threads, int smem,
                cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kFloat = static_cast<int>(sizeof(float));

template <typename T>
Kernel state_fma_for(int n) {
  if (n <= 64) return chunk_state_fma<T, 1>;
  if (n <= 128) return chunk_state_fma<T, 2>;
  if (n <= 192) return chunk_state_fma<T, 3>;
  return chunk_state_fma<T, 4>;
}

Kernel state_wgmma_for(int n) {
  if (n <= 64) return chunk_state_wgmma<1>;
  if (n <= 128) return chunk_state_wgmma<2>;
  if (n <= 192) return chunk_state_wgmma<3>;
  return chunk_state_wgmma<4>;
}

template <typename T>
cudaError_t launch_fma(const Params& p, cudaStream_t s) {
  const int n_tiles = (p.Q + kTile - 1) / kTile;
  const int na = (p.N + kTile - 1) / kTile;
  cudaError_t err = run(state_fma_for<T>(p.N), dim3(p.NC, p.H, p.B),
                        kStateThreads,
                        (kJ * kTile * na + kJ * kMaxP + kJ + p.Q) * kFloat,
                        s, p);
  if (err != cudaSuccess) return err;
  err = run(scores_fma<T>, dim3(n_tiles, n_tiles, p.B * p.NC), kFmaThreads,
            0, s, p);
  if (err != cudaSuccess) return err;
  const int np = p.N * p.P;
  if (np % 4 == 0)
    err = run(state_pass<4, false>,
              dim3((np / 4 + kStateThreads - 1) / kStateThreads, p.H, p.B),
              kStateThreads, 0, s, p);
  else
    err = run(state_pass<1, false>,
              dim3((np + kStateThreads - 1) / kStateThreads, p.H, p.B),
              kStateThreads, 0, s, p);
  if (err != cudaSuccess) return err;
  return run(chunk_output_fma<T>, dim3(n_tiles, p.NC, p.B * p.H),
             kFmaThreads, (2 * kTile * kLD + 3 * kTile) * kFloat, s, p);
}

cudaError_t launch_wgmma(const Params& p, cudaStream_t s) {
  const int n_tiles = p.Q / kTile;
  const int blocks = (p.N + 63) / 64;
  cudaError_t err = run(
      state_wgmma_for(p.N), dim3(p.NC, p.H, p.B), kWgThreads,
      (2 + 2 * (1 + blocks)) * kTileBytes + 2 * p.Q * kFloat + 1024, s, p);
  if (err != cudaSuccess) return err;
  err = run(scores_wgmma, dim3(n_tiles, n_tiles, p.B * p.NC), kWgThreads,
            2 * blocks * kTileBytes + 1024, s, p);
  if (err != cudaSuccess) return err;
  const int np = p.N * p.P;            // a multiple of 256 here
  err = run(state_pass<4, true>,
            dim3((np / 4 + kStateThreads - 1) / kStateThreads, p.H, p.B),
            kStateThreads, 0, s, p);
  if (err != cudaSuccess) return err;
  return run(chunk_output_wgmma, dim3(n_tiles, p.NC, p.B * p.H), kWgThreads,
             (3 * blocks + 2) * kTileBytes + 5 * kTile * kFloat + 1024, s,
             p);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// dims: B, S, H, P, N, Q. strides: element strides of (batch, step) for x,
// b and c in that order; x's (head, p) and b's and c's n are contiguous,
// and so are dt (B, S, H), y (B, S, H, P) and the f32 scratch buffers cs
// (B, H, NC, Q), states (B, H, NC, N, P), cb (B, NC, Q, Q) and, for path
// kWgmma, the bf16 sprev (B, H, NC, 2, N, P), NC = ceil(S / Q). path
// kWgmma takes bf16 with Q % 64 == 0, P % 16 == 0, N % 16 == 0 and
// 16-byte aligned rows of x, b and c; the wrapper checks 1 <= P <= 64,
// 1 <= N <= 256, S >= 1 and the grid limits.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* b, const void* c, const float* D,
                               void* y, float* final_state, float* cs,
                               float* states, float* cb, void* sprev,
                               const int64_t* dims,
                               const int64_t* strides, int dtype, int path,
                               void* stream) {
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.b = b;
  p.c = c;
  p.D = D;
  p.y = y;
  p.final_state = final_state;
  p.cs = cs;
  p.states = states;
  p.cb = cb;
  p.sprev = static_cast<__nv_bfloat16*>(sprev);
  p.B = static_cast<int>(dims[0]);
  p.S = static_cast<int>(dims[1]);
  p.H = static_cast<int>(dims[2]);
  p.P = static_cast<int>(dims[3]);
  p.N = static_cast<int>(dims[4]);
  p.Q = static_cast<int>(dims[5]);
  p.NC = (p.S + p.Q - 1) / p.Q;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.b_sb = strides[2];
  p.b_ss = strides[3];
  p.c_sb = strides[4];
  p.c_ss = strides[5];
  if (p.P < 1 || p.P > kMaxP || p.N < 1 || p.N > kMaxN || p.S < 1 ||
      p.Q < 1 || cb == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kWgmma) {
    const bool rows16 = aligned16(x) && aligned16(b) && aligned16(c) &&
                        p.x_sb % 8 == 0 && p.x_ss % 8 == 0 &&
                        p.b_sb % 8 == 0 && p.b_ss % 8 == 0 &&
                        p.c_sb % 8 == 0 && p.c_ss % 8 == 0;
    if (dtype != kBF16 || p.Q % kTile != 0 || p.P % 16 != 0 ||
        p.N % 16 != 0 || !rows16 || sprev == nullptr)
      return cudaErrorInvalidValue;
    return launch_wgmma(p, s);
  }
  if (path != kFma) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_fma<float>(p, s);
    case kBF16: return launch_fma<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
