// FedAvg server reduce on Hopper: out[m] = sum_c w[c] * x[c, m].
//
// Replaces repro/kernels/fedavg_reduce.py::_block_reduce (the Pallas TPU
// kernel that fedavg_reduce and fedavg_reduce_tree launch once per leaf).
// That kernel tiles the client stack into (N, 4096) VMEM blocks and walks
// them in a sequential grid; nothing of that layout carries over.
//
// What bounds it: bytes. Each call reads the (N, M) client stack once and
// writes M outputs, doing 2 flops per element read, far below the card's
// 295 flops/byte balance point. So the design only keeps the memory system
// busy and reads each byte exactly once:
//   * each thread owns VEC consecutive columns (VEC = 4 for f32, 8 for bf16)
//     and reads them as one 16-byte load per client row; neighbouring
//     threads read neighbouring 16-byte chunks, so a warp reads 512
//     contiguous bytes of a row;
//   * each thread walks the clients c = 0..N-1 in order, holding the f32
//     sums in registers; the loop is unrolled so several rows' loads are in
//     flight at once; the (N,) f32 weights come through the read-only cache;
//   * a grid-stride loop covers M with at most kMaxBlocks blocks;
//   * no atomics and no cross-block reduction: every output has one owner
//     and a fixed summation order, so results repeat bitwise run to run.
// The 16-byte path needs every row 16-byte aligned: aligned base pointers
// and M a multiple of VEC. Any other leaf (M = 62 or 8193, an offset view)
// runs the scalar path, one column per thread, still coalesced across the
// warp.
//
// The output is the input's dtype, or f32 for a bf16 stack: the per-rank
// partial of the client-sharded reduce (repro/kernels/fedavg_reduce.py::
// fedavg_reduce_sharded, whose shard body writes f32), which the wrapper
// all-reduces across ranks before the cast.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

// dtype tags shared with repro_torch/kernels/fedavg_reduce.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte chunk of a row: load, weight and accumulate; store the sums.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;

  __device__ __forceinline__ static void fma(const float* p, float w,
                                             float (&acc)[kVec]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }

};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;

  __device__ __forceinline__ static void fma(const __nv_bfloat16* p, float w,
                                             float (&acc)[kVec]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
};

// Store a thread's V sums as 16-byte writes: f32 as V/4 float4, bf16 as
// one uint4 of 8 values (bf16 output comes only from bf16 input, V = 8).
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&acc)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&acc)[V]) {
  static_assert(V == 8, "bf16 output takes 8 values a thread");
  __align__(16) __nv_bfloat16 out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = __float2bfloat16_rn(acc[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(out);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    reduce_vec(const T* __restrict__ x, const float* __restrict__ w,
               O* __restrict__ out, int n, int64_t m) {
  constexpr int V = Chunk<T>::kVec;
  const int64_t groups = m / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    const T* col = x + g * V;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      Chunk<T>::fma(col + static_cast<int64_t>(c) * m, __ldg(w + c), acc);
    }
    store_vec<V>(out + g * V, acc);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    reduce_scalar(const T* __restrict__ x, const float* __restrict__ w,
                  O* __restrict__ out, int n, int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < m; j += stride) {
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      acc = fmaf(__ldg(w + c), load1(x + static_cast<int64_t>(c) * m + j),
                 acc);
    }
    store1(out + j, acc);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T, typename O>
void launch(const void* x, const float* w, void* out, int n, int64_t m,
            cudaStream_t stream) {
  constexpr int V = Chunk<T>::kVec;
  const T* xt = static_cast<const T*>(x);
  O* ot = static_cast<O*>(out);
  if (m % V == 0 && aligned16(x) && aligned16(out)) {
    reduce_vec<T, O><<<blocks_for(m / V), kThreads, 0, stream>>>(xt, w, ot,
                                                                 n, m);
  } else {
    reduce_scalar<T, O><<<blocks_for(m), kThreads, 0, stream>>>(xt, w, ot,
                                                               n, m);
  }
}

}  // namespace

// x: (n, m) row-major of dtype `dtype`; w: (n,) f32; out: (m,) of
// `out_dtype`, which is `dtype` or f32 (the f32 partial a rank of the
// client-sharded reduce all-reduces, fedavg_reduce_sharded).
extern "C" int fedavg_reduce_launch(const void* x, const void* w, void* out,
                                    int n, int64_t m, int dtype,
                                    int out_dtype, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) {
    launch<float, float>(x, wf, out, n, m, s);
  } else if (dtype == kBF16 && out_dtype == kBF16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, wf, out, n, m, s);
  } else if (dtype == kBF16 && out_dtype == kF32) {
    launch<__nv_bfloat16, float>(x, wf, out, n, m, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
