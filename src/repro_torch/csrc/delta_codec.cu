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
// What bounds them on the data sheet: bytes. None does more than two flops
// per byte it moves, far below the card's balance point, so none needs
// tensor cores and each design reads every input byte once and writes
// every output byte once. At the CIFAR100 `fc` leaf (N = 25 clients,
// M = 2,097,152), against the data sheet's 3.35 TB/s:
//   int8_reduce, one plane: 52.4 MB in + 8.4 MB out -> 18.2 us; two planes
//     113.2 MB -> 33.8 us;
//   int8_apply, one plane: 18.9 MB -> 5.6 us; two planes 21.0 MB -> 6.3 us;
//   topk_reduce: 25 x 209,716 x 8 B payload + 8.4 MB out -> 15.0 us, before
//     the random 32-byte sectors its scattered adds touch;
//   topk_apply: 8.4 + 8.4 + 1.7 MB -> 5.5 us.
// The top-k reduce meets two other bounds first: the order of its adds,
// and the rate of atomic adds at L2 (PERF.md section 6).
//
// int8_reduce keeps fedavg_reduce.cu's shape: each thread owns 16
// consecutive columns, reads them as one 16-byte load per client row and
// plane, walks the clients in order with f32 sums in registers (one set
// per plane, added at the end as the reference adds its two sums), and
// grid-strides over M. No atomics, so results repeat bitwise. A scalar
// path takes rows that are not 16-byte aligned (M % 16 != 0, offset
// views).
//
// int8_apply is elementwise, `ref + q*s [+ qr*rs]` with separately rounded
// multiplies and adds, so it repeats the plain PyTorch version bit for bit.
// Its layout keeps every load and store instruction of a warp on
// contiguous bytes: a lane's unit is 16 bytes of ref and of out (4 f32 or
// 8 bf16 values, a warp covering 512 B) and the int8 under them (a 4-byte
// word a lane in f32, 128 B a warp; 8 bytes in bf16). A warp step takes 4
// units a lane (16 f32 or 32 bf16 values), the units of one instruction
// side by side; the warps stride over the steps, and the loads of a
// warp's next step are issued before the stores of the current one. The
// last step checks each unit against M. An earlier layout gave each thread
// 16 consecutive values, so each instruction of a warp spread over 2 KB
// and used half of every 32-byte sector it touched. The path needs ref
// and out 16-byte aligned, the planes aligned to their unit and M a
// multiple of the unit; a scalar path takes any other view. The scales
// are read from device memory, so the host never waits for them.
//
// The top-k kernels drop the TPU's one-hot matmul (its stand-in for a
// scatter, delta_codec.py:26-42): on Hopper the scatter is a scatter, and
// each kernel is one cooperative launch a call (cudaLaunchCooperativeKernel:
// every block resident at once, so a grid barrier cannot hang).
// lax.top_k and torch.topk return distinct indices within a row, so the
// adds of one row go each to its own address, and what fixes the order of
// an output's sum is the order of the rows. topk_reduce keeps client order:
// it zeroes out, then walks the rows, each row's entries split over the
// grid (kPer a thread a step, loaded a step ahead: loads do not depend on
// the order, only adds do) and added with atomicAdd, and a grid barrier
// (cooperative_groups' grid sync: release and acquire at gpu scope) after
// each row, so every add of row c is performed before any add of row c + 1.
// So the result repeats bitwise from run to run (the port's C==U and resume
// contracts need that) and equals the plain version's row-by-row
// index_add_. A row of at most kOneBlockEntries runs on one block, with
// block barriers: there a grid barrier costs more than the steps it saves.
// What bounds it: the atomic adds' rate at L2 on large leaves (index_add_
// meets the same bound) and a barrier and a step's round trips a row on
// small ones. (A design that gave each block a tile of the output in shared
// memory, reading every row whole, lost on the wire path's shapes: shared
// f32 adds are compare-and-swap loops on Hopper, and a cluster barrier is a
// gpu-scope fence.) A row that does hold a duplicate index (only tests
// build one) is still summed right, though not in a fixed order. Indices
// outside [0, M) (the -1 padding) are skipped. topk_apply copies ref into
// out (16-byte copies), a grid barrier, then adds each entry in f32:
// atomicAdd for f32; for bf16 a 16-bit compare-and-swap of
// bf16(f32(out) + v), which is the plain version's f32 sum rounded once
// wherever indices are distinct (a duplicate rounds once per add). Neither
// needs a scratch buffer.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrappers raise if that is not 0.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kVec = 16;  // values per thread on the 16-byte paths

// dtype tags shared with repro_torch/kernels/delta_codec.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__host__ __device__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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

// the 4 int8 of a 32-bit word, as floats
__device__ __forceinline__ void unpack4(unsigned int word, float* f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = static_cast<float>(static_cast<int8_t>(word >> (8 * j)));
  }
}

// 16 int8 values of one 16-byte load, as floats
__device__ __forceinline__ void unpack16(const int4 raw, float (&f)[kVec]) {
  unpack4(raw.x, f);
  unpack4(raw.y, f + 4);
  unpack4(raw.z, f + 8);
  unpack4(raw.w, f + 12);
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

__device__ __forceinline__ void store16(float* p, const float (&v)[kVec]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
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

// One lane's unit on the 16-byte path: 16 bytes of ref and out (kVals
// values) and the kVals int8 of each plane under them (4 bytes in f32, 8 in
// bf16).
template <typename T>
struct ApplyUnit;

template <>
struct ApplyUnit<float> {
  static constexpr int kVals = 4;
  using Ref = float4;
  using Q = unsigned int;
  __device__ __forceinline__ static Ref load_ref(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static Q load_q(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ static void unpack_ref(const Ref& r,
                                                    float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void unpack_q(const Q& q, float (&f)[4]) {
    unpack4(q, f);
  }
  __device__ __forceinline__ static void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct ApplyUnit<__nv_bfloat16> {
  static constexpr int kVals = 8;
  using Ref = uint4;
  using Q = uint2;
  __device__ __forceinline__ static Ref load_ref(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Q load_q(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void unpack_ref(const Ref& r,
                                                    float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      v[2 * j] = t.x;
      v[2 * j + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void unpack_q(const Q& q, float (&f)[8]) {
    unpack4(q.x, f);
    unpack4(q.y, f + 4);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
};

constexpr int kApplyUnits = 4;  // 16-byte units a lane a step

// One step's registers: kApplyUnits units a lane.
template <typename T, bool kTwo>
struct ApplyStep {
  typename ApplyUnit<T>::Ref r[kApplyUnits];
  typename ApplyUnit<T>::Q q[kApplyUnits];
  typename ApplyUnit<T>::Q qr[kTwo ? kApplyUnits : 1];
};

// Unit k of a lane's step starts at base + k * 32 * kVals: each load and
// store instruction of the warp covers contiguous bytes. A unit at or past
// m is skipped (m is a multiple of kVals, so a unit is whole or absent).
template <typename T, bool kTwo>
__device__ __forceinline__ void apply_load(const T* ref, const int8_t* q,
                                           const int8_t* qr, int64_t base,
                                           int64_t m,
                                           ApplyStep<T, kTwo>& st) {
  using U = ApplyUnit<T>;
#pragma unroll
  for (int k = 0; k < kApplyUnits; ++k) {
    const int64_t u = base + k * 32 * U::kVals;
    if (u < m) {
      st.r[k] = U::load_ref(ref + u);
      st.q[k] = U::load_q(q + u);
      if constexpr (kTwo) st.qr[k] = U::load_q(qr + u);
    }
  }
}

template <typename T, bool kTwo>
__device__ __forceinline__ void apply_store(T* out, int64_t base, int64_t m,
                                            float sc, float rsc,
                                            const ApplyStep<T, kTwo>& st) {
  using U = ApplyUnit<T>;
#pragma unroll
  for (int k = 0; k < kApplyUnits; ++k) {
    const int64_t u = base + k * 32 * U::kVals;
    if (u < m) {
      float v[U::kVals], f[U::kVals];
      U::unpack_ref(st.r[k], v);
      U::unpack_q(st.q[k], f);
#pragma unroll
      for (int i = 0; i < U::kVals; ++i) {
        v[i] = __fadd_rn(v[i], __fmul_rn(f[i], sc));
      }
      if constexpr (kTwo) {
        U::unpack_q(st.qr[k], f);
#pragma unroll
        for (int i = 0; i < U::kVals; ++i) {
          v[i] = __fadd_rn(v[i], __fmul_rn(f[i], rsc));
        }
      }
      U::store(out + u, v);
    }
  }
}

// values a warp covers in one step
template <typename T>
constexpr int64_t kApplyTile = 32 * ApplyUnit<T>::kVals * kApplyUnits;

// Each warp walks the steps (tiles of kApplyTile values) t = warp, warp +
// warps, ...; the loads of its next step are issued before the stores of
// the current one, from two register buffers.
template <typename T, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    int8_apply_vec(const T* __restrict__ ref, const int8_t* __restrict__ q,
                   const float* __restrict__ s, const int8_t* __restrict__ qr,
                   const float* __restrict__ rs, T* __restrict__ out,
                   int64_t m) {
  constexpr int64_t kTile = kApplyTile<T>;
  const float sc = __ldg(s);
  const float rsc = kTwo ? __ldg(rs) : 0.f;
  const int64_t off = (threadIdx.x & 31) * ApplyUnit<T>::kVals;
  const int64_t warps = grid_stride() / 32;
  const int64_t tiles = (m + kTile - 1) / kTile;
  int64_t t = first_index() / 32;
  if (t >= tiles) return;
  ApplyStep<T, kTwo> a, b;
  apply_load<T, kTwo>(ref, q, qr, t * kTile + off, m, a);
  for (;;) {
    int64_t next = t + warps;
    if (next < tiles) {
      apply_load<T, kTwo>(ref, q, qr, next * kTile + off, m, b);
    }
    apply_store<T, kTwo>(out, t * kTile + off, m, sc, rsc, a);
    t = next;
    if (t >= tiles) break;
    next = t + warps;
    if (next < tiles) {
      apply_load<T, kTwo>(ref, q, qr, next * kTile + off, m, a);
    }
    apply_store<T, kTwo>(out, t * kTile + off, m, sc, rsc, b);
    t = next;
    if (t >= tiles) break;
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
  constexpr int V = ApplyUnit<T>::kVals;
  const bool vec = m % V == 0 && aligned16(ref) && aligned16(out) &&
                   aligned_to(q, V) && (!kTwo || aligned_to(qr, V));
  if (vec) {
    const int64_t tiles = (m + kApplyTile<T> - 1) / kApplyTile<T>;
    int8_apply_vec<T, kTwo><<<blocks_for(tiles * 32), kThreads, 0, st>>>(
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
// top-k scatter-add reduce: out[idx[c, t]] += w[c] * vals[c, t] for idx in
// [0, m), client rows in order; and apply: out = ref + scatter(vals, idx)
// ---------------------------------------------------------------------------

constexpr int kTopkThreads = 256;  // threads a block
constexpr int kPer = 4;            // payload entries a thread adds a step
// A payload row of at most this many entries runs on one block, with block
// barriers between rows: a grid barrier costs more than the steps it saves.
constexpr int64_t kOneBlockEntries = 2 * kPer * kTopkThreads;

// The steps of the walk over the payload, in row order: step (c, h) is
// chunk h of row c. Counted up, never divided: a 64-bit division is a
// software routine, and a step is a few instructions.
struct StepCursor {
  int c = 0;
  int64_t h = 0;
  __device__ __forceinline__ void next(int64_t chunks) {
    if (++h == chunks) {
      h = 0;
      ++c;
    }
  }
};

// A thread's share of one step: kPer payload entries of one client row and
// the row's weight. Index -1 (past the row, or past the last row) matches
// no output.
struct Slot {
  float v[kPer];
  int32_t i[kPer];
  float w;
};

// The thread's entries of step `at` are first + (h * kPer + k) * stride.
__device__ __forceinline__ void load_step(
    Slot& sl, const float* __restrict__ vals, const int32_t* __restrict__ idx,
    const float* __restrict__ w, const StepCursor& at, int n, int64_t s,
    int64_t first, int64_t stride) {
  const bool live = at.c < n;
  const int64_t row = int64_t{at.c} * s;
  const int64_t t0 = at.h * kPer * stride + first;
  sl.w = live ? __ldg(w + at.c) : 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t t = t0 + k * stride;
    sl.i[k] = -1;
    sl.v[k] = 0.f;
    if (live && t < s) {
      sl.i[k] = __ldg(idx + row + t);
      sl.v[k] = __ldg(vals + row + t);
    }
  }
}

// Between two client rows: every add of the row before is performed before
// any add of the row after (cooperative_groups' grid barrier releases and
// acquires at gpu scope; a one-block grid needs only the block barrier).
__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
}

// One cooperative grid: out = 0, then the rows in client order, each row's
// entries split over the grid and added with atomicAdd, a grid barrier
// after each row. A step's loads are issued a step ahead: they do not
// depend on the order of the adds.
__global__ void __launch_bounds__(kTopkThreads)
    topk_reduce_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int n, int64_t s, int64_t m) {
  const int64_t first = first_index();
  const int64_t stride = grid_stride();
  const int64_t chunks = (s + kPer * stride - 1) / (kPer * stride);
  StepCursor load_at, add_step;
  Slot next;
  load_step(next, vals, idx, w, load_at, n, s, first, stride);
  load_at.next(chunks);
  const int64_t groups = aligned16(out) ? m / 4 : 0;
  for (int64_t g = first; g < groups; g += stride) {
    reinterpret_cast<float4*>(out)[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int64_t j = groups * 4 + first; j < m; j += stride) out[j] = 0.f;
  grid_barrier();
  while (add_step.c < n) {  // the same for every thread of the grid
    const Slot cur = next;
    load_step(next, vals, idx, w, load_at, n, s, first, stride);
    load_at.next(chunks);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (cur.i[k] >= 0 && cur.i[k] < m) {
        atomicAdd(out + cur.i[k], __fmul_rn(cur.w, cur.v[k]));
      }
    }
    add_step.next(chunks);
    if (add_step.h == 0 && add_step.c < n) grid_barrier();
  }
}

__device__ __forceinline__ void add_at(float* p, float v) { atomicAdd(p, v); }

// ref's type is bf16: the sum in f32, rounded once, swapped in with a
// 16-bit compare-and-swap (a duplicate index rounds once per add)
__device__ __forceinline__ void add_at(__nv_bfloat16* p, float v) {
  unsigned short* u = reinterpret_cast<unsigned short*>(p);
  unsigned short old = *u;
  unsigned short assumed;
  do {
    assumed = old;
    const float sum =
        __fadd_rn(__bfloat162float(__ushort_as_bfloat16(assumed)), v);
    old = atomicCAS(u, assumed,
                    __bfloat16_as_ushort(__float2bfloat16_rn(sum)));
  } while (old != assumed);
}

// One cooperative grid: out = ref (16-byte copies where aligned), a grid
// barrier, then out[idx[t]] += vals[t] in f32.
template <typename T>
__global__ void __launch_bounds__(kTopkThreads)
    topk_apply_kernel(const T* __restrict__ ref,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ idx, T* __restrict__ out,
                      int64_t s, int64_t m) {
  const int64_t first = first_index();
  const int64_t stride = grid_stride();
  int32_t ii[kPer];
  float vv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t t = first + k * stride;
    ii[k] = -1;
    vv[k] = 0.f;
    if (t < s) {
      ii[k] = __ldg(idx + t);
      vv[k] = __ldg(vals + t);
    }
  }
  constexpr int kElems = 16 / sizeof(T);
  const int64_t groups = aligned16(ref) && aligned16(out) ? m / kElems : 0;
  const uint4* r4 = reinterpret_cast<const uint4*>(ref);
  uint4* o4 = reinterpret_cast<uint4*>(out);
#pragma unroll 4
  for (int64_t g = first; g < groups; g += stride) o4[g] = __ldg(r4 + g);
  for (int64_t j = groups * kElems + first; j < m; j += stride) {
    out[j] = ref[j];
  }
  grid_barrier();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (ii[k] >= 0 && ii[k] < m) add_at(out + ii[k], vv[k]);
  }
  for (int64_t t = first + kPer * stride; t < s; t += stride) {
    const int64_t i = __ldg(idx + t);
    if (i >= 0 && i < m) add_at(out + i, __ldg(vals + t));
  }
}

// Blocks of each top-k kernel the current card holds at once (what a
// cooperative launch may use), found once per device.
struct CoopLimits {
  int reduce = 0;
  int apply[2] = {0, 0};  // by dtype tag
};

cudaError_t coop_limits(const CoopLimits** out) {
  static CoopLimits limits[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  CoopLimits& l = limits[dev];
  if (l.reduce == 0) {
    int sms = 0, a = 0, b = 0, c = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &a, topk_reduce_kernel, kTopkThreads, 0);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, topk_apply_kernel<float>, kTopkThreads, 0);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c, topk_apply_kernel<__nv_bfloat16>, kTopkThreads, 0);
    }
    if (e != cudaSuccess) return e;
    l.apply[kF32] = b * sms;
    l.apply[kBF16] = c * sms;
    l.reduce = a * sms;
  }
  *out = &l;
  return cudaSuccess;
}

// blocks for `work` threads' worth, at least 1, at most `limit`
unsigned int coop_blocks(int64_t work, int limit) {
  const int64_t b = (work + kTopkThreads - 1) / kTopkThreads;
  return static_cast<unsigned int>(std::max<int64_t>(1, std::min<int64_t>(
      b, limit)));
}

// the reduce's grid for rows of s entries
unsigned int reduce_blocks(int64_t s, const CoopLimits& lim) {
  if (s <= kOneBlockEntries) return 1;
  return coop_blocks((s + kPer - 1) / kPer, lim.reduce);
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

// vals: (n, s) f32; idx: (n, s) int32; w: (n,) f32; out: (m,) f32. One
// cooperative launch.
extern "C" int topk_reduce_launch(const void* vals, const void* idx,
                                  const void* w, void* out, int n, int64_t s,
                                  int64_t m, void* stream) {
  if (n <= 0 || s <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CoopLimits* lim = nullptr;
  cudaError_t e = coop_limits(&lim);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* v = static_cast<const float*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  void* args[] = {&v, &ix, &wf, &o, &n, &s, &m};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(topk_reduce_kernel),
      dim3(reduce_blocks(s, *lim)), dim3(kTopkThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ref, out: (m,) of `dtype`; vals: (s,) f32; idx: (s,) int32. One
// cooperative launch.
extern "C" int topk_apply_launch(const void* ref, const void* vals,
                                 const void* idx, void* out, int64_t s,
                                 int64_t m, int dtype, void* stream) {
  if (s <= 0 || m <= 0 || (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CoopLimits* lim = nullptr;
  cudaError_t e = coop_limits(&lim);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t elems = dtype == kF32 ? 4 : 8;  // a 16-byte copy
  const unsigned int blocks = coop_blocks(
      std::max((s + kPer - 1) / kPer, m / elems), lim->apply[dtype]);
  const float* v = static_cast<const float*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  void* args[] = {&ref, &v, &ix, &out, &s, &m};
  const void* fn =
      dtype == kF32
          ? reinterpret_cast<const void*>(topk_apply_kernel<float>)
          : reinterpret_cast<const void*>(topk_apply_kernel<__nv_bfloat16>);
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kTopkThreads), args,
                                  0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
