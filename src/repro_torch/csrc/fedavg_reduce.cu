// FedAvg server reduce on Hopper: out[m] = sum_c w[c] * x[c, m], for every
// leaf of a client-stacked parameter tree in one launch.
//
// Replaces repro/kernels/fedavg_reduce.py::_block_reduce (the Pallas TPU
// kernel that fedavg_reduce and fedavg_reduce_tree launch once per leaf).
// That kernel tiles the client stack into (N, 4096) VMEM blocks and walks
// them in a sequential grid; nothing of that layout carries over.
//
// What bounds it: bytes on a large leaf, the latency of the client walk on
// a small one. Each leaf reads its (N, M) client stack once and writes M
// outputs, doing 2 flops per element read, far below the card's 295
// flops/byte balance point; a leaf of a few hundred columns moves a few KB
// and waits on device memory once per round trip its walk makes.
//
// The order is fixed. Every output is acc = 0, then acc = fmaf(w[c],
// x[c, m], acc) for c = 0, 1, ..., N-1 in order, in f32, then one store in
// the output dtype: no atomics, no split of N, no cross-block sum. So the
// result repeats bitwise run to run, and a one-stack call (fedavg_reduce),
// a tree call (fedavg_reduce_tree) and a rank's partial of the client-
// sharded reduce give the same bits: MeshBackend, which reduces leaf by
// leaf, equals LocalBackend, which reduces the tree, bit for bit.
//
// Rows in flight: a thread loads a chunk of R client rows of its columns
// (and their weights) into registers, and issues the next chunk's loads
// before it runs the current chunk's fmafs, from two register buffers;
// only the fmafs wait on each other. N = 60 then costs about two round
// trips on the one-column path (R = 16) and four on the 16-byte path
// (R = 8), not the fifteen of a loop unrolled by four.
//
// Columns a thread: a leaf takes the 16-byte path (VEC = 4 f32 or 8 bf16
// columns a thread, one 16-byte load a row, a warp reading 512 contiguous
// bytes of a row) when its rows are 16-byte aligned (aligned base pointers,
// M a multiple of VEC) and it has at least a block of threads for every SM
// at that width. Every other leaf runs one column a thread, still
// coalesced across the warp: a small leaf gets VEC times the threads, each
// with twice the rows in flight, and M = 62 or 8193 or an offset view
// needs no other code.
//
// The tree table: the wrapper (kernels/fedavg_reduce.py::plan_launches,
// once for each layout of its arguments) groups the leaves by (input,
// output) dtype, at most kMaxLeaves a launch, and gives each leaf its path
// and a range of blocks; a call packs the table with the leaves' addresses
// and checks nothing the plan has settled. The table travels by
// value in the kernel's parameters (__grid_constant__, read in place from
// the constant bank): nothing is copied to the card, nothing synchronises.
// Each block finds its leaf by a binary search over the first blocks and
// grid-strides over that leaf's columns with the leaf's blocks.
//
// The output is the input's dtype, or f32 for a bf16 stack: the per-rank
// partial of the client-sharded reduce (repro/kernels/fedavg_reduce.py::
// fedavg_reduce_sharded, whose shard body writes f32), which the wrapper
// all-reduces across ranks before the cast.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The launch's layout. The wrapper plans with kThreads and kMaxLeaves and
// checks them against fedavg_reduce_layout once, when it loads the library.
constexpr int kThreads = 256;     // threads a block
constexpr int kMaxLeaves = 64;    // leaves a table holds
constexpr int kRowsVec = 8;       // client rows a chunk on the 16-byte path
constexpr int kRowsScalar = 16;   // the same on one column a thread

// dtype tags shared with repro_torch/kernels/fedavg_reduce.py
enum DType : int { kF32 = 0, kBF16 = 1 };

// One leaf of a launch: 32 bytes, as kernels/fedavg_reduce.py packs it.
struct Leaf {
  const void* x;        // (n, m) row-major, input dtype
  void* out;            // (m,), output dtype
  int64_t m;
  int32_t first_block;  // the leaf owns blocks [first_block, next leaf's)
  int32_t vec;          // 1: the 16-byte path; 0: one column a thread
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int32_t count;
};

// V columns of T: the raw registers of one row's load, and the fmaf of a
// weighted row into the V sums.
template <typename T, int V>
struct Cols;

template <>
struct Cols<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& v,
                                             float (&acc)[4]) {
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
};

template <>
struct Cols<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void fma(float w, const Raw& v,
                                             float (&acc)[1]) {
    acc[0] = fmaf(w, v, acc[0]);
  }
};

template <>
struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& v,
                                             float (&acc)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
};

template <>
struct Cols<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& v,
                                             float (&acc)[1]) {
    acc[0] = fmaf(w, __bfloat162float(__ushort_as_bfloat16(v)), acc[0]);
  }
};

// columns a thread on the 16-byte path
template <typename T>
constexpr int kVecOf = 16 / static_cast<int>(sizeof(T));

// Store a thread's V sums: one value, or 16-byte writes (f32 as V/4
// float4, bf16 as one uint4 of 8 values; bf16 output comes only from bf16
// input, V = 8).
template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&acc)[V]) {
  if constexpr (V == 1) {
    *p = acc[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&acc)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(acc[0]);
  } else {
    static_assert(V == 8, "bf16 output takes 8 values a thread");
    __align__(16) __nv_bfloat16 o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __float2bfloat16_rn(acc[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
}

// Issue the loads of rows c0 .. c0+R-1 (those below n) of the columns at
// col, and of their weights. Nothing waits on them here.
template <typename T, int V, int R>
__device__ __forceinline__ void load_rows(const T* col, int64_t m,
                                          const float* w, int c0, int n,
                                          typename Cols<T, V>::Raw (&v)[R],
                                          float (&wv)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (c0 + r < n) {
      v[r] = Cols<T, V>::load(col + static_cast<int64_t>(c0 + r) * m);
      wv[r] = __ldg(w + c0 + r);
    }
  }
}

// The chain: rows c0 .. c0+R-1 (those below n) into the sums, in order.
template <typename T, int V, int R>
__device__ __forceinline__ void fma_rows(
    const typename Cols<T, V>::Raw (&v)[R], const float (&wv)[R], int c0,
    int n, float (&acc)[V]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (c0 + r < n) Cols<T, V>::fma(wv[r], v[r], acc);
  }
}

// One leaf: V columns a thread, R rows a chunk, two chunks in registers.
template <typename T, typename O, int V, int R>
__device__ __forceinline__ void reduce_leaf(const T* __restrict__ x,
                                            const float* __restrict__ w,
                                            O* __restrict__ out, int n,
                                            int64_t m, int64_t first,
                                            int64_t stride) {
  using Raw = typename Cols<T, V>::Raw;
  const int64_t groups = m / V;
  for (int64_t g = first; g < groups; g += stride) {
    const T* col = x + g * V;
    Raw a[R], b[R];
    float wa[R], wb[R], acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    load_rows<T, V, R>(col, m, w, 0, n, a, wa);
    for (int c0 = 0;;) {
      if (c0 + R < n) load_rows<T, V, R>(col, m, w, c0 + R, n, b, wb);
      fma_rows<T, V, R>(a, wa, c0, n, acc);
      c0 += R;
      if (c0 >= n) break;
      if (c0 + R < n) load_rows<T, V, R>(col, m, w, c0 + R, n, a, wa);
      fma_rows<T, V, R>(b, wb, c0, n, acc);
      c0 += R;
      if (c0 >= n) break;
    }
    store_cols<V>(out + g * V, acc);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads, 2)
    reduce_tree(const __grid_constant__ Table t, const float* __restrict__ w,
                int n) {
  // the block's leaf: the last whose first block is at most blockIdx.x
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& leaf = t.leaf[lo];
  const int end = lo + 1 < t.count ? t.leaf[lo + 1].first_block
                                   : static_cast<int>(gridDim.x);
  const int64_t first =
      static_cast<int64_t>(b - leaf.first_block) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(end - leaf.first_block) *
                         kThreads;
  const T* x = static_cast<const T*>(leaf.x);
  O* out = static_cast<O*>(leaf.out);
  if (leaf.vec) {
    reduce_leaf<T, O, kVecOf<T>, kRowsVec>(x, w, out, n, leaf.m, first,
                                           stride);
  } else {
    reduce_leaf<T, O, 1, kRowsScalar>(x, w, out, n, leaf.m, first, stride);
  }
}

}  // namespace

// The launch's layout, for the wrapper: kThreads, kMaxLeaves, kRowsVec and
// kRowsScalar into out[0..3].
extern "C" void fedavg_reduce_layout(int* out) {
  out[0] = kThreads;
  out[1] = kMaxLeaves;
  out[2] = kRowsVec;
  out[3] = kRowsScalar;
}

// leaves: a host array of `count` Leaf records (the launch's table, copied
// into the kernel's parameters), planned by the wrapper: the first leaf
// owns block 0, each leaf at least one block, first blocks ascending, the
// last leaf [its first_block, blocks). w: (n,) f32 on the card, shared by
// every leaf; out dtype is `dtype` or f32 (the f32 partial a rank of the
// client-sharded reduce all-reduces, fedavg_reduce_sharded).
extern "C" int fedavg_reduce_tree_launch(const void* leaves, int count,
                                         const void* w, int n, int dtype,
                                         int out_dtype, int blocks,
                                         void* stream) {
  if (count <= 0 || count > kMaxLeaves || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  std::memcpy(t.leaf, leaves, sizeof(Leaf) * count);
  t.count = count;
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) {
    reduce_tree<float, float><<<blocks, kThreads, 0, s>>>(t, wf, n);
  } else if (dtype == kBF16 && out_dtype == kBF16) {
    reduce_tree<__nv_bfloat16, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        t, wf, n);
  } else if (dtype == kBF16 && out_dtype == kF32) {
    reduce_tree<__nv_bfloat16, float><<<blocks, kThreads, 0, s>>>(t, wf, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
