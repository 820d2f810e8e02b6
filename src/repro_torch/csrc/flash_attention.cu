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
//     would give exp(-inf - -inf) = NaN); key blocks wholly masked for the
//     whole query tile are skipped;
//   * running max, denominator and accumulator in f32; the output is
//     acc / max(l, 1e-30) in q's dtype.
// Keys past Sk (the ragged last tile) score -inf, so they add exactly 0:
// the kernel takes any Sq and Sk, where the TPU wrapper padded to 128, and
// hd 16, 32, 64, 112, 128 or 192 (the configs' head dims), where it padded
// hd to 128.
//
// What bounds it: operations. Each (query, key) pair costs 4*hd flops
// (q.k and p*v) and the pairs grow as S^2, while the bytes grow as S*hd: at
// the qwen1.5-0.5b prefill shape (B 2, H 16, S 4096, hd 64, f32, causal)
// one launch needs 68.7 GFLOP against 134 MB, about 500 flops a byte. This
// first version is plain FMA on the CUDA cores, in f32 for f32 and bf16
// inputs alike (bf16 is widened as it is staged), so its ceiling is the
// card's f32 rate; wgmma and TMA are later work. The design keeps the FMA
// pipes fed from shared memory:
//   * one CTA of 256 threads per (head, batch, 64-query tile); the query
//     tile is staged once, then 64-key K and V tiles in turn, all as f32
//     rows padded by 4 floats so the 16-byte reads below are conflict-free;
//   * thread (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i and
//     keys tx + 16 j (i, j < 4): each 16-byte read of Q and of K feeds 16
//     FMAs of its 4 x 4 score block; the 16 threads of a row sit in one
//     half-warp, so the row max is four shuffles;
//   * P goes through shared memory, and the same thread computes P.V for
//     its 4 rows over hd/16 output columns, one 16-byte read of P per 4
//     keys and row;
//   * the grid runs the longest query tiles first (the causal frontier
//     makes late tiles the heaviest), so the last wave is short.
// No atomics and a fixed order of every sum: results repeat bitwise.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDP = kBK + 16;   // P row stride: the two half-warps' rows
                                 // land 16 banks apart
constexpr float kMasked = -1e30f;

// dtype tags shared with repro_torch/kernels/flash_attention.py
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

__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// Stage rows [row0, row0 + 64) of one (b, h) slice into dst as f32 rows of
// stride HD + 4; rows at or past `limit` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      int64_t row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + 4;
  // 16-byte chunks of a row: 4 f32 or 8 bf16
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = HD / kPer;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kPer;
    float* d = dst + r * LD + col;
    const int row = row0 + r;
    if (row >= limit) {
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const T* src = base + row * row_stride + col;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(d) =
          __ldg(reinterpret_cast<const float4*>(src));
    } else {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
      float f[8];
      bf16x2_to_f32(w.x, f);
      bf16x2_to_f32(w.y, f + 2);
      bf16x2_to_f32(w.z, f + 4);
      bf16x2_to_f32(w.w, f + 6);
      *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

template <typename T, int HD>
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

  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  T* ob = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];

  stage<T, HD>(Qs, qb, p.qs[2], q0, p.Sq);

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
    stage<T, HD>(Ks, kb, p.ks[2], k0, p.Sk);
    stage<T, HD>(Vs, vb, p.vs[2], k0, p.Sk);
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
    T* orow = ob + qi * p.os[2];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store1(orow + (tx + 16 * n) * VW + e, acc[i][n * VW + e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 112: return launch<T, 112>(p, stream);   // zamba2-7b's shared block
    case 128: return launch<T, 128>(p, stream);
    case 192: return launch<T, 192>(p, stream);   // nemotron-4-340b
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, H, KV, Sq, Sk, hd. strides: element strides of (b, h, s) for q,
// k, v and o in that order; the last dim is contiguous and every row starts
// 16-byte aligned (the wrapper checks). window <= 0 and softcap <= 0 mean
// none.
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
    case kF32: return dispatch_hd<float>(hd, p, s);
    case kBF16: return dispatch_hd<__nv_bfloat16>(hd, p, s);
    default: return cudaErrorInvalidValue;
  }
}
