// The compressed wire path's kernels on Hopper: int8 decompress-reduce,
// int8 decode-apply, and the top-k scatter-add reduce and apply.
//
// Replaces the Pallas TPU kernels of repro/kernels/delta_codec.py:
//   int8_reduce  <- int8_decompress_reduce (:102): the two-plane
//                   _block_reduce2 (pallas_call at :85), and the one-plane
//                   case, which ran fedavg_reduce's _block_reduce on int8
//                   input (repro/kernels/fedavg_reduce.py:81, via :111);
//   int8_apply   <- int8_decode_apply (:200): _apply_kernel1 (pallas_call
//                   at :178) and _apply_kernel2 (:187);
//   topk_reduce  <- topk_scatter_reduce_mosaic (:309, pallas_call at :324);
//   topk_apply   <- topk_scatter_apply_mosaic (:340, pallas_call at :356).
//
// What bounds them: bytes. None does more than two flops per byte it
// moves, far below the card's balance point, so none needs tensor cores
// and each design only reads every input byte once and writes every output
// byte once. At the CIFAR100 `fc` leaf (N = 25 clients, M = 2,097,152),
// against the data sheet's 3.35 TB/s:
//   int8_reduce, one plane: 52.4 MB in + 8.4 MB out -> 18.2 us; two planes
//     113.2 MB -> 33.8 us;
//   int8_apply, one plane: 18.9 MB -> 5.6 us; two planes 21.0 MB -> 6.3 us;
//   topk_reduce: 25 x 209,716 x 8 B payload + 8.4 MB out -> 15.0 us, before
//     the random 32-byte sectors its scattered adds touch;
//   topk_apply: 8.4 + 8.4 + 1.7 MB -> 5.5 us.
//
// int8_reduce keeps fedavg_reduce.cu's shape: each thread owns 16
// consecutive columns, reads them as one 16-byte load per client row and
// plane, walks the clients in order with f32 sums in registers (one set
// per plane, added at the end as the reference adds its two sums), and
// grid-strides over M. No atomics, so results repeat bitwise. A scalar
// path takes rows that are not 16-byte aligned (M % 16 != 0, offset
// views).
//
// int8_apply is elementwise: 16 values a thread (one 16-byte int8 load per
// plane, 16-byte loads and stores of ref and out), `ref + q*s [+ qr*rs]`
// with separately rounded multiplies and adds, so it repeats the plain
// PyTorch version bit for bit. The scales are read from device memory, so
// the host never waits for them.
//
// The top-k kernels drop the TPU's one-hot matmul (its stand-in for a
// scatter, delta_codec.py:26-42): on Hopper the scatter is a scatter.
// topk_reduce zeroes the output and then launches one scatter-add kernel
// per client row, in client order, on one stream. Within a row each entry
// does atomicAdd(out[idx], w_c * v). lax.top_k and torch.topk return
// distinct indices within a row, so every add of one launch goes to its
// own address and each output is summed in client order: the result
// repeats bitwise from run to run (the port's later C==U and resume
// contracts need that) and equals the plain version's row-by-row
// index_add_. A row that does hold a duplicate index (only tests build
// one) is still summed right, though not in a fixed order. Indices outside
// [0, M) (the -1 padding) are skipped. topk_apply copies ref into an f32
// accumulator (the output itself for f32; a scratch buffer, widened, for
// bf16), runs the same scatter-add with weight 1 and, for bf16, narrows
// the accumulator into the output.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrappers raise if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kVec = 16;  // values per thread on the 16-byte paths

// dtype tags shared with repro_torch/kernels/delta_codec.py
enum DType : int { kF32 = 0, kBF16 = 1 };

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) return 1;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// 16 int8 values of one 16-byte load, as floats
__device__ __forceinline__ void unpack16(const int4 raw, float (&f)[kVec]) {
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * k + j] = static_cast<float>(static_cast<int8_t>(
          static_cast<unsigned int>(words[k]) >> (8 * j)));
    }
  }
}

__device__ __forceinline__ int4 load_i8x16(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load16(const float* p, float (&v)[kVec]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = __ldg(p4 + i);
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[kVec]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = __ldg(p4 + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kVec]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[kVec]) {
  __align__(16) __nv_bfloat16 o[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = __float2bfloat16_rn(v[i]);
  uint4* p4 = reinterpret_cast<uint4*>(p);
  p4[0] = reinterpret_cast<const uint4*>(o)[0];
  p4[1] = reinterpret_cast<const uint4*>(o)[1];
}

// ---------------------------------------------------------------------------
// int8 decompress-reduce: out[m] = sum_c w[c] q[c, m] (+ sum_c wr[c] qr[c, m])
// ---------------------------------------------------------------------------

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
    int8_reduce_vec(const int8_t* __restrict__ q, const float* __restrict__ w,
                    const int8_t* __restrict__ qr,
                    const float* __restrict__ wr, float* __restrict__ out,
                    int n, int64_t m) {
  const int64_t groups = m / kVec;
  for (int64_t g = first_index(); g < groups; g += grid_stride()) {
    float acc[kVec], accr[kVec], f[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = accr[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int64_t off = static_cast<int64_t>(c) * m + g * kVec;
      const float wc = __ldg(w + c);
      unpack16(load_i8x16(q + off), f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wc, f[i], acc[i]);
      if (kTwo) {
        const float wrc = __ldg(wr + c);
        unpack16(load_i8x16(qr + off), f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) accr[i] = fmaf(wrc, f[i], accr[i]);
      }
    }
    if (kTwo) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += accr[i];
    }
    store16(out + g * kVec, acc);
  }
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
    int8_reduce_scalar(const int8_t* __restrict__ q,
                       const float* __restrict__ w,
                       const int8_t* __restrict__ qr,
                       const float* __restrict__ wr, float* __restrict__ out,
                       int n, int64_t m) {
  for (int64_t j = first_index(); j < m; j += grid_stride()) {
    float acc = 0.f, accr = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int64_t off = static_cast<int64_t>(c) * m + j;
      acc = fmaf(__ldg(w + c), static_cast<float>(q[off]), acc);
      if (kTwo) accr = fmaf(__ldg(wr + c), static_cast<float>(qr[off]), accr);
    }
    out[j] = kTwo ? acc + accr : acc;
  }
}

template <bool kTwo>
void int8_reduce(const int8_t* q, const float* w, const int8_t* qr,
                 const float* wr, float* out, int n, int64_t m,
                 cudaStream_t s) {
  const bool vec = m % kVec == 0 && aligned16(q) && aligned16(out) &&
                   (!kTwo || aligned16(qr));
  if (vec) {
    int8_reduce_vec<kTwo><<<blocks_for(m / kVec), kThreads, 0, s>>>(
        q, w, qr, wr, out, n, m);
  } else {
    int8_reduce_scalar<kTwo><<<blocks_for(m), kThreads, 0, s>>>(
        q, w, qr, wr, out, n, m);
  }
}

// ---------------------------------------------------------------------------
// int8 decode-apply: out = ref + q*s (+ qr*rs), in f32, stored as ref's type
// ---------------------------------------------------------------------------

template <typename T, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    int8_apply_vec(const T* __restrict__ ref, const int8_t* __restrict__ q,
                   const float* __restrict__ s, const int8_t* __restrict__ qr,
                   const float* __restrict__ rs, T* __restrict__ out,
                   int64_t m) {
  const float sc = __ldg(s);
  const float rsc = kTwo ? __ldg(rs) : 0.f;
  const int64_t groups = m / kVec;
  for (int64_t g = first_index(); g < groups; g += grid_stride()) {
    float r[kVec], f[kVec];
    load16(ref + g * kVec, r);
    unpack16(load_i8x16(q + g * kVec), f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) r[i] = __fadd_rn(r[i], __fmul_rn(f[i], sc));
    if (kTwo) {
      unpack16(load_i8x16(qr + g * kVec), f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        r[i] = __fadd_rn(r[i], __fmul_rn(f[i], rsc));
      }
    }
    store16(out + g * kVec, r);
  }
}

template <typename T, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    int8_apply_scalar(const T* __restrict__ ref, const int8_t* __restrict__ q,
                      const float* __restrict__ s,
                      const int8_t* __restrict__ qr,
                      const float* __restrict__ rs, T* __restrict__ out,
                      int64_t m) {
  const float sc = __ldg(s);
  const float rsc = kTwo ? __ldg(rs) : 0.f;
  for (int64_t j = first_index(); j < m; j += grid_stride()) {
    float r = __fadd_rn(load1(ref + j),
                        __fmul_rn(static_cast<float>(q[j]), sc));
    if (kTwo) r = __fadd_rn(r, __fmul_rn(static_cast<float>(qr[j]), rsc));
    store1(out + j, r);
  }
}

template <typename T, bool kTwo>
void int8_apply(const void* ref, const int8_t* q, const float* s,
                const int8_t* qr, const float* rs, void* out, int64_t m,
                cudaStream_t st) {
  const T* rt = static_cast<const T*>(ref);
  T* ot = static_cast<T*>(out);
  const bool vec = m % kVec == 0 && aligned16(ref) && aligned16(q) &&
                   aligned16(out) && (!kTwo || aligned16(qr));
  if (vec) {
    int8_apply_vec<T, kTwo><<<blocks_for(m / kVec), kThreads, 0, st>>>(
        rt, q, s, qr, rs, ot, m);
  } else {
    int8_apply_scalar<T, kTwo><<<blocks_for(m), kThreads, 0, st>>>(
        rt, q, s, qr, rs, ot, m);
  }
}

template <typename T>
void int8_apply_planes(const void* ref, const int8_t* q, const float* s,
                       const int8_t* qr, const float* rs, void* out,
                       int64_t m, cudaStream_t st) {
  if (qr != nullptr) {
    int8_apply<T, true>(ref, q, s, qr, rs, out, m, st);
  } else {
    int8_apply<T, false>(ref, q, s, qr, rs, out, m, st);
  }
}

// ---------------------------------------------------------------------------
// top-k scatter-add: acc[idx[t]] += (w ? *w : 1) * vals[t] for idx in [0, m)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    scatter_add_row(const float* __restrict__ vals,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ acc,
                    int64_t s, int64_t m) {
  const float wc = w != nullptr ? __ldg(w) : 1.f;
  for (int64_t t = first_index(); t < s; t += grid_stride()) {
    const int64_t i = __ldg(idx + t);
    if (i >= 0 && i < m) {
      const float v = __ldg(vals + t);
      atomicAdd(acc + i, w != nullptr ? __fmul_rn(wc, v) : v);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    widen_bf16(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
               int64_t m) {
  for (int64_t j = first_index(); j < m; j += grid_stride()) {
    y[j] = load1(x + j);
  }
}

__global__ void __launch_bounds__(kThreads)
    narrow_bf16(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                int64_t m) {
  for (int64_t j = first_index(); j < m; j += grid_stride()) {
    store1(y + j, x[j]);
  }
}

}  // namespace

// q, qr: (n, m) int8 row-major (qr may be null: one plane); w, wr: (n,) f32;
// out: (m,) f32.
extern "C" int int8_reduce_launch(const void* q, const void* w,
                                  const void* qr, const void* wr, void* out,
                                  int n, int64_t m, void* stream) {
  if (n <= 0 || m <= 0 || (qr == nullptr) != (wr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* qri = static_cast<const int8_t*>(qr);
  const float* wf = static_cast<const float*>(w);
  const float* wrf = static_cast<const float*>(wr);
  float* of = static_cast<float*>(out);
  if (qr != nullptr) {
    int8_reduce<true>(qi, wf, qri, wrf, of, n, m, s);
  } else {
    int8_reduce<false>(qi, wf, qri, wrf, of, n, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ref, out: (m,) of `dtype`; q, qr: (m,) int8 (qr may be null); s, rs: one
// f32 each, in device memory.
extern "C" int int8_apply_launch(const void* ref, const void* q,
                                 const void* s, const void* qr,
                                 const void* rs, void* out, int64_t m,
                                 int dtype, void* stream) {
  if (m <= 0 || (qr == nullptr) != (rs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* qri = static_cast<const int8_t*>(qr);
  const float* sf = static_cast<const float*>(s);
  const float* rsf = static_cast<const float*>(rs);
  switch (dtype) {
    case kF32:
      int8_apply_planes<float>(ref, qi, sf, qri, rsf, out, m, st);
      break;
    case kBF16:
      int8_apply_planes<__nv_bfloat16>(ref, qi, sf, qri, rsf, out, m, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: (n, s) f32; idx: (n, s) int32; w: (n,) f32; out: (m,) f32. Zeroes
// out, then launches one scatter-add per client row, in row order.
extern "C" int topk_reduce_launch(const void* vals, const void* idx,
                                  const void* w, void* out, int n, int64_t s,
                                  int64_t m, void* stream) {
  if (n <= 0 || s <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(out);
  cudaError_t e = cudaMemsetAsync(acc, 0, m * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* v = static_cast<const float*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  for (int c = 0; c < n; ++c) {
    const int64_t row = static_cast<int64_t>(c) * s;
    scatter_add_row<<<blocks_for(s), kThreads, 0, st>>>(v + row, ix + row,
                                                         wf + c, acc, s, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// ref, out: (m,) of `dtype`; vals: (s,) f32; idx: (s,) int32; acc: (m,) f32
// accumulator (the output itself when dtype is f32).
extern "C" int topk_apply_launch(const void* ref, const void* vals,
                                 const void* idx, void* acc, void* out,
                                 int64_t s, int64_t m, int dtype,
                                 void* stream) {
  if (s <= 0 || m <= 0 || (dtype == kF32 && acc != out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  cudaError_t e = cudaSuccess;
  switch (dtype) {
    case kF32:
      e = cudaMemcpyAsync(a, ref, m * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
      break;
    case kBF16:
      widen_bf16<<<blocks_for(m), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(ref), a, m);
      e = cudaGetLastError();
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_add_row<<<blocks_for(s), kThreads, 0, st>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(idx),
      nullptr, a, s, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dtype == kBF16) {
    narrow_bf16<<<blocks_for(m), kThreads, 0, st>>>(
        a, static_cast<__nv_bfloat16*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
