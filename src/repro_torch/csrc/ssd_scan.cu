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
// broadcast to every head. Neither carries over. Hopper blocks run in
// parallel and carry nothing; at the mamba2-780m prefill (B 2, H 48) there
// are only 96 (batch, head) pairs for 132 SMs, each with 16 chunks to walk
// in order, and a 256 x 256 f32 gate tile (256 KB) does not fit in a
// block's 227 KB of shared memory. So the scan runs as the three passes of
// the chunked algorithm itself, all on the caller's stream:
//   1. chunk_state: one CTA per (chunk, head, batch) (1,536 at the prefill)
//      takes the chunk's cumsum of dt*A (warp shuffles, written to a
//      scratch `cs` (B, H, NC, Q)) and its own state
//      sum_j exp(cs_last - cs_j) dt_j B_j x_j^T into a scratch `states`
//      (B, H, NC, N, P);
//   2. state_pass: one thread per (state element, head, batch) walks the
//      chunks in order, replaces each chunk's own state by the state that
//      enters it, and writes the final state;
//   3. chunk_output: one CTA per (64-row query tile, chunk, batch*head)
//      (6,144 at the prefill) computes its rows' y: C.B^T for each 64-key
//      tile up to the diagonal (tiles above it are never computed), the
//      decay gate, the product with x, then the inter-chunk term from the
//      entering state and the D skip, and stores y in x's dtype. The grid
//      runs the longest (last) query tiles of a chunk first.
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
// H 48, P 64, N 128, Q 256, f32) the algorithm needs ~19.6 GFLOP (C.B^T once
// per batch and chunk, the causal half only) against ~214 MB moved:
// 0.29 ms at the card's f32 rate outside the tensor cores, 0.064 ms for the
// bytes. This first version recomputes C.B^T for each head on the causal
// 64 x 64 tiles (10 of 16 per chunk), ~37 GFLOP in all, on the FMA units in
// f32 for f32 and bf16 inputs alike (bf16 is widened as it is staged).
// Thread (ty, tx) of a 16 x 16 layout owns rows ty + 16 a and columns
// tx + 16 b (a, b < 4) of each 64 x 64 product, read from shared rows
// padded to an odd stride so the 16 rows a warp reads fall in 16 banks.
// No atomics and a fixed order of every sum: results repeat bitwise.
//
// The C entry point allocates nothing (the Python wrapper passes the two
// scratch buffers) and returns the first CUDA error of the three launches;
// the wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // query rows and keys per tile (pass 3)
constexpr int kMaxP = 64;        // head_dim the kernel takes
constexpr int kMaxN = 256;       // d_state the kernel takes
constexpr int kJ = 32;           // steps staged at a time (pass 1)
constexpr int kLDG = kTile + 1;  // gate row stride (pass 3)

// dtype tags shared with repro_torch/kernels/ssd_scan.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
  int B, S, H, P, N, Q, NC;
  int64_t x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// Pass 1: the chunk's cumsum of dt*A and its own state. kNA: d_state per
// thread along n (N <= 16 kNA); thread (tn, tp) owns n = tn + 16 a and
// p = tp + 16 q.
template <typename T, int kNA>
__global__ void __launch_bounds__(kThreads)
chunk_state(Params p) {
  extern __shared__ float smem[];
  float* bs = smem;                   // [kJ][N]
  float* xs = bs + kJ * p.N;          // [kJ][kMaxP], x scaled by the weight
  float* ws = xs + kJ * kMaxP;        // [kJ] exp(cs_last - cs_j) dt_j
  float* cs = ws + kJ;                // [Q]
  const int ch = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int s0 = ch * p.Q;
  const int nvalid = min(p.Q, p.S - s0);   // real steps of this chunk
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  float* cs_out = p.cs + (bh * p.NC + ch) * p.Q;

  if (tid < 32) {                     // warp 0: inclusive scan of dt*A
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
  __syncthreads();
  const float cs_last = cs[p.Q - 1];

  const T* xb = static_cast<const T*>(p.x) + bb * p.x_sb +
                static_cast<int64_t>(h) * p.P;
  const T* bsrc = static_cast<const T*>(p.b) + bb * p.b_sb;
  const int tn = tid / 16, tp = tid % 16;
  float acc[kNA][4];
#pragma unroll
  for (int a = 0; a < kNA; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;

  for (int j0 = 0; j0 < nvalid; j0 += kJ) {
    const int jn = min(kJ, nvalid - j0);
    if (tid < jn)
      ws[tid] = expf(cs_last - cs[j0 + tid]) *
                p.dt[(static_cast<int64_t>(bb) * p.S + s0 + j0 + tid) * p.H +
                     h];
    __syncthreads();
    for (int e = tid; e < kJ * p.N; e += kThreads) {
      const int jj = e / p.N, n = e % p.N;
      bs[e] = jj < jn ? to_f32(bsrc[(s0 + j0 + jj) * p.b_ss + n]) : 0.f;
    }
    for (int e = tid; e < kJ * kMaxP; e += kThreads) {
      const int jj = e / kMaxP, q = e % kMaxP;
      xs[e] = (jj < jn && q < p.P)
          ? ws[jj] * to_f32(xb[(s0 + j0 + jj) * p.x_ss + q]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      float bv[kNA], xv[4];
#pragma unroll
      for (int a = 0; a < kNA; ++a) {
        const int n = tn + 16 * a;
        bv[a] = n < p.N ? bs[jj * p.N + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[jj * kMaxP + tp + 16 * q];
#pragma unroll
      for (int a = 0; a < kNA; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(bv[a], xv[q], acc[a][q]);
    }
    __syncthreads();
  }

  float* out = p.states + (bh * p.NC + ch) * p.N * p.P;
#pragma unroll
  for (int a = 0; a < kNA; ++a) {
    const int n = tn + 16 * a;
    if (n >= p.N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tp + 16 * q;
      if (pp < p.P) out[n * p.P + pp] = acc[a][q];
    }
  }
}

// Pass 2: one thread per state element walks the chunks in order; each
// chunk's slot ends up holding the state that enters it.
__global__ void __launch_bounds__(kThreads)
state_pass(Params p) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int np = p.N * p.P;
  if (e >= np) return;
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  float st = 0.f;
  for (int ch = 0; ch < p.NC; ++ch) {
    const int64_t slot = (bh * p.NC + ch) * np + e;
    const float own = p.states[slot];
    p.states[slot] = st;
    const float decay = expf(p.cs[(bh * p.NC + ch) * p.Q + p.Q - 1]);
    st = st * decay + own;
  }
  p.final_state[bh * np + e] = st;
}

// Pass 3: the output rows of one 64-step query tile of one chunk and head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_output(Params p) {
  extern __shared__ float smem[];
  const int ldn = p.N + 1;            // odd row stride: conflict-free columns
  float* cs_ = smem;                  // [kTile][ldn]   C rows of the tile
  float* bs = cs_ + kTile * ldn;      // [kTile][ldn]   B rows of a key tile;
                                      // then S_prev [N][kMaxP]
  float* xs = bs + kTile * ldn;       // [kTile][kMaxP] x rows of a key tile
  float* gs = xs + kTile * kMaxP;     // [kTile][kLDG]  the gate
  float* csi = gs + kTile * kLDG;     // [kTile] cs of the query rows
  float* csj = csi + kTile;           // [kTile] cs of the keys
  float* dtj = csj + kTile;           // [kTile] dt of the keys

  const int n_tiles = (p.Q + kTile - 1) / kTile;
  const int it = n_tiles - 1 - blockIdx.x;      // longest tiles first
  const int ch = blockIdx.y;
  const int bb = blockIdx.z / p.H, h = blockIdx.z % p.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = ch * p.Q;
  const int nvalid = min(p.Q, p.S - s0);
  const int i0 = it * kTile;
  if (i0 >= nvalid) return;           // a tile wholly past S
  const int ni = min(kTile, nvalid - i0);
  const int64_t bh = static_cast<int64_t>(bb) * p.H + h;
  const float* cs_g = p.cs + (bh * p.NC + ch) * p.Q;
  const T* xb = static_cast<const T*>(p.x) + bb * p.x_sb +
                static_cast<int64_t>(h) * p.P;
  const T* bsrc = static_cast<const T*>(p.b) + bb * p.b_sb;
  const T* csrc = static_cast<const T*>(p.c) + bb * p.c_sb;
  const float* dtb = p.dt + static_cast<int64_t>(bb) * p.S * p.H + h;

  for (int e = tid; e < kTile * p.N; e += kThreads) {
    const int r = e / p.N, n = e % p.N;
    cs_[r * ldn + n] =
        r < ni ? to_f32(csrc[(s0 + i0 + r) * p.c_ss + n]) : 0.f;
  }
  if (tid < kTile) csi[tid] = tid < ni ? cs_g[i0 + tid] : 0.f;

  float y[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) y[a][q] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    const int nj = min(kTile, nvalid - j0);
    for (int e = tid; e < kTile * p.N; e += kThreads) {
      const int r = e / p.N, n = e % p.N;
      bs[r * ldn + n] =
          r < nj ? to_f32(bsrc[(s0 + j0 + r) * p.b_ss + n]) : 0.f;
    }
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int r = e / kMaxP, q = e % kMaxP;
      xs[e] = (r < nj && q < p.P)
          ? to_f32(xb[(s0 + j0 + r) * p.x_ss + q]) : 0.f;
    }
    if (tid < kTile) {
      csj[tid] = tid < nj ? cs_g[j0 + tid] : 0.f;
      dtj[tid] = tid < nj ? dtb[static_cast<int64_t>(s0 + j0 + tid) * p.H]
                          : 0.f;
    }
    __syncthreads();

    // scores C_i . B_j of this thread's 4 x 4 block
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[a][q] = 0.f;
    for (int n = 0; n < p.N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = cs_[(ty + 16 * a) * ldn + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * ldn + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[a][q] = fmaf(cv[a], bv[q], sc[a][q]);
    }
    // the gate: select i >= j (and real keys) before the exponent
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = tx + 16 * q, j = j0 + k;
        float g = 0.f;
        if (r < ni && k < nj && j <= i)
          g = expf(csi[r] - csj[k]) * dtj[k] * sc[a][q];
        gs[r * kLDG + k] = g;
      }
    }
    __syncthreads();

    // y += gate @ x
    for (int k = 0; k < nj; ++k) {
      float gv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = gs[(ty + 16 * a) * kLDG + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[k * kMaxP + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) y[a][q] = fmaf(gv[a], xv[q], y[a][q]);
    }
    __syncthreads();
  }
  // xs now holds the x rows of the query tile (the last key tile was the
  // diagonal one), unscaled: the D skip reads them below.

  if (ch > 0) {                       // chunk 0 enters with a zero state
    const float* sp = p.states + (bh * p.NC + ch) * p.N * p.P;
    float* ss = bs;                   // S_prev [N][kMaxP]
    for (int e = tid; e < p.N * kMaxP; e += kThreads) {
      const int n = e / kMaxP, q = e % kMaxP;
      ss[e] = q < p.P ? sp[n * p.P + q] : 0.f;
    }
    __syncthreads();
    float yi[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) yi[a][q] = 0.f;
    for (int n = 0; n < p.N; ++n) {
      float cv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = cs_[(ty + 16 * a) * ldn + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = ss[n * kMaxP + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) yi[a][q] = fmaf(cv[a], sv[q], yi[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float dec = expf(csi[ty + 16 * a]);
#pragma unroll
      for (int q = 0; q < 4; ++q) y[a][q] += dec * yi[a][q];
    }
  }

  const float d = p.D[h];
  T* yb = static_cast<T*>(p.y);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= ni) continue;
    T* yrow = yb + ((static_cast<int64_t>(bb) * p.S + s0 + i0 + r) * p.H +
                    h) * p.P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx + 16 * q;
      if (pp < p.P) store1(yrow + pp, y[a][q] + d * xs[r * kMaxP + pp]);
    }
  }
}

template <typename T, int kNA>
cudaError_t launch_state(const Params& p, cudaStream_t stream) {
  const int smem =
      (kJ * p.N + kJ * kMaxP + kJ + p.Q) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state<T, kNA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chunk_state<T, kNA><<<dim3(p.NC, p.H, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (p.N <= 16) err = launch_state<T, 1>(p, stream);
  else if (p.N <= 32) err = launch_state<T, 2>(p, stream);
  else if (p.N <= 64) err = launch_state<T, 4>(p, stream);
  else if (p.N <= 128) err = launch_state<T, 8>(p, stream);
  else err = launch_state<T, 16>(p, stream);
  if (err != cudaSuccess) return err;

  const int np = p.N * p.P;
  state_pass<<<dim3((np + kThreads - 1) / kThreads, p.H, p.B), kThreads, 0,
               stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem = (2 * kTile * (p.N + 1) + kTile * kMaxP + kTile * kLDG +
                    3 * kTile) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(chunk_output<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Q + kTile - 1) / kTile, p.NC, p.B * p.H);
  chunk_output<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dims: B, S, H, P, N, Q. strides: element strides of (batch, step) for x,
// b and c in that order; x's (head, p) and b's and c's n are contiguous,
// and so are dt (B, S, H), y (B, S, H, P) and the f32 scratch buffers cs
// (B, H, NC, Q) and states (B, H, NC, N, P), NC = ceil(S / Q). The wrapper
// checks 1 <= P <= 64, 1 <= N <= 256, S >= 1 and the grid limits.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* b, const void* c, const float* D,
                               void* y, float* final_state, float* cs,
                               float* states, const int64_t* dims,
                               const int64_t* strides, int dtype,
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
      p.Q < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_all<float>(p, s);
    case kBF16: return launch_all<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
