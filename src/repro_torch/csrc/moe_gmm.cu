// Grouped matmul of the MoE expert FFN on Hopper: out[e] = x[e] @ w[e].
//
// Replaces src/repro/kernels/moe_gmm.py:61 (the Pallas TPU kernel `gmm`,
// its `_kernel`), which the MoE dispatch path runs three times a layer
// through kernels/ops.py::moe_gmm (gate, up, down). x is (E, C, d), w is
// (E, d, f), out is (E, C, f); each sum runs in f32 and is stored in x's
// dtype (f32 or bf16). The TPU kernel walked a sequential (E, C/BC, f/BF,
// d/BD) grid with d innermost and an f32 VMEM accumulator carried from one
// grid step to the next, and its wrapper padded C to 128. Hopper blocks run
// in no order and carry nothing between them, so here each CTA owns one
// (expert, 128 x 128 output tile) and loops over d itself, the sums in
// registers; ragged edges of C, d and f are masked in the kernel, so any
// C, d, f >= 1 is taken without padding.
//
// What bounds it: operations. At the phi3.5-moe prefill (B 2 x S 4096,
// top-2 of 16 experts, capacity C = 1280) the gate and up calls are
// (16, 1280, 4096) @ (16, 4096, 6400): 1.074 TFLOP against 2.54 GB moved,
// about 420 flops a byte. At the card's f32 rate outside the tensor cores
// (67 TFLOP/s) that is 16.0 ms; the bytes alone would take 0.76 ms. This
// first version stays on the FMA units in f32 for f32 and bf16 inputs alike
// (bf16 is widened as it is staged): TF32 would change the numbers, and
// wgmma with TMA for bf16 is later work.
//
// The design keeps the FMA pipes fed from shared memory:
//   * one CTA of 256 threads per (f tile, C tile, expert); the grid walks f
//     tiles fastest, so neighbouring CTAs share their x rows in L2;
//   * 16-deep slices of x (transposed, rows padded by 4 floats) and of w are
//     staged in shared memory as f32, with 16-byte loads where the rows
//     allow; the next slice is loaded into registers while the current one
//     is multiplied (two shared buffers, one barrier a slice);
//   * thread (ty, tx) of a 16 x 16 layout owns an 8 x 8 micro-tile of f32
//     sums: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
//     with tx. Each depth step reads 16 floats of shared memory with four
//     16-byte loads for 64 FMAs; the 16 threads of a half-warp read the
//     same x words (a broadcast) and neighbouring w words, so shared memory
//     stays under half busy when the FMA pipes are full.
// No atomics, and each sum runs over d in one fixed order: a call repeats
// bit for bit.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;        // rows of C per CTA
constexpr int kBN = 128;        // columns of f per CTA
constexpr int kBK = 16;         // depth of d per staged slice
constexpr int kThreads = 256;   // 16 x 16, an 8 x 8 micro-tile each
constexpr int kLDA = kBM + 4;   // row stride of the transposed x slice

// dtype tags shared with repro_torch/kernels/moe_gmm.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void bf16x2_to_f32(uint32_t v, float* out) {
  out[0] = __uint_as_float(v << 16);
  out[1] = __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive outputs, 16 (f32) or 8 (bf16) bytes, aligned.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One 16-byte chunk, 4 f32 or 8 bf16, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    bf16x2_to_f32(v.x, out);
    bf16x2_to_f32(v.y, out + 2);
    bf16x2_to_f32(v.z, out + 4);
    bf16x2_to_f32(v.w, out + 6);
  }
}

// Elements [col, col + VW) of row `row` of a (rows, cols) matrix, zeros past
// either edge. kVec: cols % VW == 0 and the base is 16-byte aligned, so a
// chunk is wholly inside or wholly outside and loads as one 16-byte word.
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* base, int row, int col,
                                           int rows, int cols, float* out) {
  constexpr int VW = 16 / sizeof(T);
  const T* src = base + static_cast<int64_t>(row) * cols + col;
  if constexpr (kVec) {
    if (row < rows && col < cols) {
      load_vec<T>(src, out);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) out[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j)
      out[j] = (row < rows && col + j < cols) ? to_f32(src[j]) : 0.f;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int d, int f) {
  constexpr int VW = 16 / sizeof(T);                  // elements a chunk
  constexpr int kAChunks = kBM * kBK / VW / kThreads;  // per thread
  constexpr int kBChunks = kBK * kBN / VW / kThreads;
  constexpr int kARow = kBK / VW;                      // chunks a row
  constexpr int kBRow = kBN / VW;
  static_assert(kAChunks >= 1 && kBChunks >= 1, "tile too small");

  __shared__ __align__(16) float As[2][kBK][kLDA];   // x slice, transposed
  __shared__ __align__(16) float Bs[2][kBK][kBN];    // w slice

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* xe = x + static_cast<int64_t>(e) * C * d;
  const T* we = w + static_cast<int64_t>(e) * d * f;
  T* oe = out + static_cast<int64_t>(e) * C * f;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float ra[kAChunks][VW];
  float rb[kBChunks][VW];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads;
      load_chunk<T, kVec>(xe, m0 + c / kARow, k0 + (c % kARow) * VW, C, d,
                          ra[i]);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kThreads;
      load_chunk<T, kVec>(we, k0 + c / kBRow, n0 + (c % kBRow) * VW, d, f,
                          rb[i]);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kARow;
      const int kc = (c % kARow) * VW;
#pragma unroll
      for (int j = 0; j < VW; ++j) As[buf][kc + j][r] = ra[i][j];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBRow;
      const int nc = (c % kBRow) * VW;
#pragma unroll
      for (int j = 0; j < VW; j += 4)
        *reinterpret_cast<float4*>(&Bs[buf][r][nc + j]) =
            make_float4(rb[i][j], rb[i][j + 1], rb[i][j + 2], rb[i][j + 3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (d + kBK - 1) / kBK;
  load(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < ktiles; ++t) {
    const int buf = t & 1;
    // the next slice travels from device memory while this one multiplies
    if (t + 1 < ktiles) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // buf ^ 1 was last read before the previous barrier: safe to refill
    if (t + 1 < ktiles) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= C) continue;
    T* orow = oe + static_cast<int64_t>(row) * f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      const float* v = &acc[i][h * 4];
      if (kVec && col + 3 < f) {
        store4(orow + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < f) store1(orow + col + j, v[j]);
      }
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C,
                   int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(int vec, const void* x, const void* w, void* out,
                         int E, int C, int d, int f, cudaStream_t stream) {
  return vec ? launch<T, true>(x, w, out, E, C, d, f, stream)
             : launch<T, false>(x, w, out, E, C, d, f, stream);
}

}  // namespace

// x (E, C, d), w (E, d, f), out (E, C, f), all contiguous and of one dtype
// (0 f32, 1 bf16); E, C, f >= 1, E and ceil(C / 128) at most 65535 (the
// wrapper checks). vec = 1 when d and f are multiples of 16 bytes' worth of
// elements and x, w and out start 16-byte aligned.
extern "C" int gmm_launch(const void* x, const void* w, void* out, int E,
                          int C, int d, int f, int dtype, int vec,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_vec<float>(vec, x, w, out, E, C, d, f, s);
    case kBF16:
      return dispatch_vec<__nv_bfloat16>(vec, x, w, out, E, C, d, f, s);
    default: return cudaErrorInvalidValue;
  }
}
