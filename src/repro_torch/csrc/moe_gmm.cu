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
// (expert, output tile) and loops over d itself, the sums in registers;
// ragged edges of C, d and f are masked or zero-filled in the kernel, so
// no padding is needed.
//
// What bounds it: operations. At the phi3.5-moe prefill (B 2 x S 4096,
// top-2 of 16 experts, capacity C = 1280) the gate and up calls are
// (16, 1280, 4096) @ (16, 4096, 6400): 1.074 TFLOP against 1.27 GB moved
// in bf16, about 850 flops a byte, far above the card's ~295 for bf16.
// The decode-dispatch floor C = 8 is bound by w's 839 MB instead.
//
// Three kernels, chosen before launch from dtype and shape alone (the
// wrapper's kernel_path):
//
// 1. bf16 with d % 8 == 0 and f % 8 == 0 (TMA's 16-byte strides; every
//    config's widths qualify): `tc::gmm_wgmma`, on the tensor cores
//    (989 TFLOP/s dense bf16; bound 1.09 ms at gate/up).
//    * One CTA per (128-row C tile, 256-column f tile, expert); the grid
//      walks C tiles fastest, so the CTAs in flight share each w tile in L2
//      and w streams from device memory about once.
//    * Warp specialisation, 384 threads: a producer warpgroup (one thread
//      issues, 40 registers) keeps a ring of 4 stages in flight, each an x
//      tile (128 x 64 of d, K-major) and a w tile (64 of d x 256, MN-major:
//      f is contiguous, so wgmma reads B transposed), loaded by TMA with
//      the 128-byte swizzle and completed on one mbarrier a stage. Two
//      consumer warpgroups (232 registers) own 64 rows each and run
//      wgmma m64n256k16 on the stage with their 128 f32 sums in registers;
//      each hands a stage back (an empty mbarrier) once the next stage's
//      wgmmas are issued and the stage's own are done, so one group of
//      wgmmas is always queued behind the running one.
//    * 3D tensor maps (d, C, E) and (f, d, E): TMA zero-fills the ragged C
//      and d edges inside one expert, never reading the next.
//    * The epilogue rounds the f32 sums to bf16 and stores bf16 pairs,
//      masked to (C, f).
//    At C = 8 the second warpgroup multiplies zero rows; the tile still
//    streams w once, which is what bounds that shape.
//    ptxas (nvcc 12.9): 168 registers, the 384-thread launch bound, of
//    which setmaxnreg moves the producer to 40 and the consumers to 232;
//    no spills.
// 2. f32 with d % 8 == 0 and f % 8 == 0: `split::gmm_wgmma_split`, on the
//    same tensor cores. Each f32 operand v is split into bf16 hi = bf16(v)
//    and lo = bf16(v - hi) (hopper.cuh, |v - hi - lo| <= 2^-18 |v|), and
//    each k16 step issues three products, in this order: x_hi.w_hi,
//    x_hi.w_lo, x_lo.w_hi (lo.lo is below f32's rounding). That is f32
//    accuracy at a third of the bf16 rate: bound 3.26 ms at gate/up, where
//    the CUDA cores' 67 TFLOP/s give 16.0 ms. TF32 would not do: it keeps
//    10 bits, and its wgmma takes no MN-major (transposed) B, which w is.
//    * The tensor cores round their f32 sums toward zero, and with three
//      products a k16 step that alone put gate/up 1.0e-4 off the exact
//      product (the split itself: 2e-5), enough to push the phi3.5-moe
//      prefill's K/V states past the f32 tolerance. So every two stages
//      (64 of d) sum into a fresh register partial (the first product
//      overwrites it), which the consumer then adds into its f32 sums on
//      the CUDA cores, rounding to nearest: 2.7e-5 off at gate/up.
//    * The split happens in the kernel, on tiles that TMA landed as f32:
//      a split pass before the GEMM would read and write w's 1.68 GB again
//      at gate/up (~1.0 ms), and at C = 8, where w's bytes are the whole
//      bound, it would double them.
//    * 128 x 128 per CTA, C tiles fastest, a producer warpgroup (40
//      registers) and two consumer warpgroups (232) of 64 rows each. A
//      stage is 32 of d: the x tile (128 x 32 f32, one 128-byte swizzled
//      row a C row, 16 KB) and the w tile (32 x 128 f32, unswizzled rows,
//      16 KB), four stages in a ring. ptxas caps a 384-thread kernel at
//      168 registers whatever setmaxnreg grants, so a consumer holds 64
//      sums, a 64-register partial and 16 registers of A fragments; a
//      128 x 256 tile (128 sums) spilled without the partial and could
//      not hold one.
//    * x is the register A operand: each consumer thread reads its
//      fragment pairs from the swizzled f32 tile (two wavefronts a warp,
//      the fewest for 256 bytes) and splits them in registers. w is the
//      MN-major B operand from shared memory, split by warps 1-3 of the
//      producer warpgroup (one thread of warp 0 issues the TMA loads) into
//      bf16 hi and lo planes at swizzle-128 offsets (each warp reads a
//      whole 512-byte row), fenced to the async proxy, in a ring of three
//      hi/lo buffers of 16 KB: the splitters run up to two stages ahead of
//      the products and the consumers never wait on each other. mbarriers: full and
//      empty for the f32 ring (empty counts the 256 consumer and 96
//      splitter threads), wfull and wempty for the w buffers. Shared
//      memory: 4 x 32 + 3 x 16 KB + barriers = 181,360 bytes.
//    * A warpgroup whose 64 rows all lie past C skips its products (C = 8
//      issues half the tensor work of path 1 there).
//    * The epilogue stores f32 pairs, masked to (C, f).
//    ptxas (nvcc 12.9): 168 registers, no spills.
// 3. f32 and bf16 at other widths (d or f not a multiple of 8):
//    `gmm_kernel`, plain FMA in f32 on the CUDA cores (bf16 is widened as
//    it is staged). Its ceiling is the 67 TFLOP/s f32 rate. It keeps the
//    FMA pipes fed from shared memory:
//    * one CTA of 256 threads per (f tile, C tile, expert), 128 x 128;
//    * 16-deep slices of x (transposed, rows padded by 4 floats) and of w
//      staged in shared memory as f32, with 16-byte loads where the rows
//      allow; the next slice is loaded into registers while the current
//      one is multiplied (two shared buffers, one barrier a slice);
//    * thread (ty, tx) of a 16 x 16 layout owns an 8 x 8 micro-tile of f32
//      sums: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
//      with tx; each depth step reads 16 floats of shared memory with four
//      16-byte loads for 64 FMAs.
//    ptxas: 128 registers; the f32 instantiation with scalar loads (d or
//    f not a multiple of 4) spills 72 bytes, the others none.
// None uses atomics or splits d: each sum runs over d in one fixed order,
// so a call repeats bit for bit.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or a tensor-map error, hopper.cuh); the Python
// wrapper raises if that is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;                  // rows of C per CTA (two warpgroups)
constexpr int kBN = 256;                  // columns of f per CTA
constexpr int kBK = 64;                   // depth of d per stage: 128-byte rows
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;    // x tile, K-major, 16 KB
constexpr int kBChunk = kBK * 64 * 2;     // w tile: 64 columns x 64 deep, 8 KB
constexpr int kBBytes = (kBN / 64) * kBChunk;
constexpr int kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kThreads = 384;             // consumers 0-255, producer 256-383

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap tx,
          const __grid_constant__ CUtensorMap tw, __nv_bfloat16* out, int C,
          int d, int f) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer group
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        uint8_t* a = smem + s * kStageBytes;
        tma_load_3d(a, &tx, &full[s], kt * kBK, m0, e);
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c)
          tma_load_3d(a + kABytes + c * kBChunk, &tw, &full[s], n0 + c * 64,
                      kt * kBK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63, all kBN columns
  setmaxnreg_inc<232>();
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t a = smem_u32(smem + s * kStageBytes) + wg * 64 * 128;
    const uint32_t b = smem_u32(smem + s * kStageBytes + kABytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) {
      // x: 16 more of d inside the 128-byte row; w: 16 more rows of d
      wgmma_m64n256k16_ss<1>(
          acc, make_desc(a + k * 32, 16, 1024, kSwizzle128),
          make_desc(b + k * 16 * 128, kBChunk, 1024, kSwizzle128), 1);
    }
    wgmma_commit();
    // the previous stage's products are done: hand its slot back
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();

  const int lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  __nv_bfloat16* oe = out + static_cast<int64_t>(e) * C * f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= f) continue;               // f % 8 == 0: pairs stay whole
    if (row < C)
      *reinterpret_cast<uint32_t*>(oe + static_cast<int64_t>(row) * f + col) =
          pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < C)
      *reinterpret_cast<uint32_t*>(oe + static_cast<int64_t>(row + 8) * f +
                                   col) =
          pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 on the tensor cores: each operand split into bf16 hi + lo in the
// kernel, three wgmma products
// ---------------------------------------------------------------------------

namespace split {

constexpr int kBM = 128;                  // rows of C per CTA (two warpgroups)
constexpr int kBN = 128;                  // columns of f per CTA
constexpr int kBK = 32;                   // depth of d per stage: 128-byte x rows
constexpr int kStages = 4;
constexpr int kXBytes = kBM * kBK * 4;    // f32 x tile, 128-byte swizzle, 16 KB
constexpr int kWRow = kBN * 4;            // f32 w tile row: 512 bytes, unswizzled
constexpr int kWBytes = kBK * kWRow;      // 16 KB
constexpr int kStageBytes = kXBytes + kWBytes;   // 32 KB
constexpr int kWChunk = kBK * 128;        // bf16 w: 64 columns x 32 deep, 4 KB
constexpr int kWPlane = (kBN / 64) * kWChunk;    // one of hi, lo: 8 KB
constexpr int kWBuf = 2 * kWPlane;        // hi then lo
constexpr int kWBufs = 3;                 // bf16 w buffers in a ring
constexpr int kBars = 2 * kStages + 2 * kWBufs;  // full, empty; wfull, wempty
constexpr int kSmem = kStages * kStageBytes + kWBufs * kWBuf + kBars * 8 +
                      1024;               // 181,360 bytes
constexpr int kThreads = 384;             // consumers 0-255, producer 256-383
constexpr int kConsumers = 256;
constexpr int kSplitters = 96;            // producer warps 1-3 (threads 288-)

// The f32 pair at (row, col), col even, of the x tile (128-byte rows of 32
// f32 under the 128-byte swizzle, as TMA wrote it).
__device__ __forceinline__ float2 x_pair(const uint8_t* xs, int row,
                                         int col) {
  return *reinterpret_cast<const float2*>(
      xs + hopper::swizzle128(row, col / 4) + (col % 4) * 4);
}

// Splits the landed f32 w tile of a stage (32 rows of d, 128 f32 each)
// into the bf16 hi and lo planes of one buffer, MN-major as the bf16
// kernel's w tiles: two 64-column chunk tiles of 32 rows of 128 bytes,
// 128-byte swizzle. Thread st of kSplitters takes 4 f32 at a time, a warp
// a whole 512-byte row (conflict-free reads; each chunk tile's row
// written whole).
__device__ __forceinline__ void split_w(const uint8_t* ws, uint8_t* hi,
                                        int st) {
  uint8_t* lo = hi + kWPlane;
#pragma unroll 2
  for (int u = st; u < kBK * kBN / 4; u += kSplitters) {
    const int k = u / (kBN / 4), c4 = u % (kBN / 4);
    const float4 v = *reinterpret_cast<const float4*>(ws + k * kWRow +
                                                      c4 * 16);
    uint2 h, l;
    hopper::split2(v.x, v.y, h.x, l.x);
    hopper::split2(v.z, v.w, h.y, l.y);
    const uint32_t off = (c4 / 16) * kWChunk +
                         hopper::swizzle128(k, (c4 % 16) / 2) + (c4 % 2) * 8;
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_split(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw, float* out, int C,
                int d, int f) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* wbuf = smem + kStages * kStageBytes;   // [kWBufs][hi, lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + kWBufs * kWBuf);
  uint64_t* empty = full + kStages;
  uint64_t* wfull = empty + kStages;
  uint64_t* wempty = wfull + kWBufs;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // the consumers read x, the splitters w
      mbar_init(&empty[s], kConsumers + kSplitters);
    }
    for (int b = 0; b < kWBufs; ++b) {
      mbar_init(&wfull[b], kSplitters);
      mbar_init(&wempty[b], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread keeps the ring of f32 tiles full,
    // warps 1-3 split each stage's w into a bf16 hi/lo buffer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        uint8_t* a = smem + s * kStageBytes;
        tma_load_3d(a, &tx, &full[s], kt * kBK, m0, e);
        tma_load_3d(a + kXBytes, &tw, &full[s], n0, kt * kBK, e);
      }
    } else if (threadIdx.x >= 256 + 32) {
      const int st = threadIdx.x - 256 - 32;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, b = kt % kWBufs;
        mbar_wait(&wempty[b], ((kt / kWBufs) & 1) ^ 1);
        mbar_wait(&full[s], (kt / kStages) & 1);
        split_w(smem + s * kStageBytes + kXBytes, wbuf + b * kWBuf, st);
        fence_proxy_async();     // the planes, to wgmma's async proxy
        mbar_arrive(&empty[s]);
        mbar_arrive(&wfull[b]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63, all kBN columns
  setmaxnreg_inc<232>();
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;   // tile row
  const int cq = 2 * (lane % 4);
  // a warpgroup whose rows all lie past C issues no products (C = 8)
  const bool active = m0 + wg * 64 < C;
  // acc: the f32 sums; part: two stages' products (64 of d), added into
  // acc on the CUDA cores (the tensor cores' own f32 accumulation rounds
  // toward zero, and three products a k16 step triple those roundings)
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages, b = kt % kWBufs;
    mbar_wait(&full[s], (kt / kStages) & 1);
    // x: this thread's A fragments of both k16 steps, split in registers
    // (a[0] row r0, d 2q..; a[1] row r0 + 8; a[2], a[3] the same 8 deeper)
    const uint8_t* xs = smem + s * kStageBytes;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = x_pair(xs, r0 + 8 * (i & 1), 16 * kk + cq +
                                                          8 * (i >> 1));
        split2(v.x, v.y, ahi[kk][i], alo[kk][i]);
      }
    }
    mbar_arrive(&empty[s]);      // this thread's x is in registers
    mbar_wait(&wfull[b], (kt / kWBufs) & 1);
    if (active) {
      const uint8_t* hi = wbuf + b * kWBuf;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bh = make_desc(smem_u32(hi + kk * 16 * 128), kWChunk,
                                      1024, kSwizzle128);
        const uint64_t bl = make_desc(smem_u32(hi + kWPlane + kk * 16 * 128),
                                      kWChunk, 1024, kSwizzle128);
        wgmma_m64n128k16_rs<1>(part, ahi[kk], bh, kk > 0 || kt % 2);
        wgmma_m64n128k16_rs<1>(part, ahi[kk], bl, 1);
        wgmma_m64n128k16_rs<1>(part, alo[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (kt % 2 || kt + 1 == nk) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
      }
    }
    mbar_arrive(&wempty[b]);     // this thread's products on b are done
  }

  const int row = m0 + r0;
  float* oe = out + static_cast<int64_t>(e) * C * f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
    if (col >= f) continue;               // f % 8 == 0: pairs stay whole
    if (row < C)
      *reinterpret_cast<float2*>(oe + static_cast<int64_t>(row) * f + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < C)
      *reinterpret_cast<float2*>(oe + static_cast<int64_t>(row + 8) * f +
                                 col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace split

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

// x (E, C, d), w (E, d, f), out (E, C, f), all contiguous bf16 and
// 16-byte aligned, d % 8 == 0, f % 8 == 0; E, C, f >= 1, E and
// ceil(f / 256) at most 65535 (the wrapper checks).
extern "C" int gmm_wgmma_launch(const void* x, const void* w, void* out,
                                int E, int C, int d, int f, void* stream) {
  using namespace hopper;
  CUtensorMap tx, tw;
  const uint64_t xdims[3] = {static_cast<uint64_t>(d),
                             static_cast<uint64_t>(C),
                             static_cast<uint64_t>(E)};
  const uint64_t xstrides[2] = {2ull * d, 2ull * C * d};
  const uint32_t xbox[3] = {tc::kBK, tc::kBM, 1};
  int err = encode_bf16_map(&tx, x, 3, xdims, xstrides, xbox, kSwizzle128);
  if (err != 0) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(f),
                             static_cast<uint64_t>(d),
                             static_cast<uint64_t>(E)};
  const uint64_t wstrides[2] = {2ull * f, 2ull * d * f};
  const uint32_t wbox[3] = {64, tc::kBK, 1};
  err = encode_bf16_map(&tw, w, 3, wdims, wstrides, wbox, kSwizzle128);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc::gmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((C + tc::kBM - 1) / tc::kBM, (f + tc::kBN - 1) / tc::kBN,
                  E);
  tc::gmm_wgmma<<<grid, tc::kThreads, tc::kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<__nv_bfloat16*>(out), C, d, f);
  return cudaGetLastError();
}

// x (E, C, d), w (E, d, f), out (E, C, f), all contiguous f32 and 16-byte
// aligned, d % 8 == 0, f % 8 == 0; E, C, f >= 1, E and ceil(f / 128) at
// most 65535 (the wrapper checks).
extern "C" int gmm_wgmma_split_launch(const void* x, const void* w,
                                      void* out, int E, int C, int d, int f,
                                      void* stream) {
  using namespace hopper;
  CUtensorMap tx, tw;
  const uint64_t xdims[3] = {static_cast<uint64_t>(d),
                             static_cast<uint64_t>(C),
                             static_cast<uint64_t>(E)};
  const uint64_t xstrides[2] = {4ull * d, 4ull * C * d};
  const uint32_t xbox[3] = {split::kBK, split::kBM, 1};
  int err = encode_f32_map(&tx, x, 3, xdims, xstrides, xbox, kSwizzle128);
  if (err != 0) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(f),
                             static_cast<uint64_t>(d),
                             static_cast<uint64_t>(E)};
  const uint64_t wstrides[2] = {4ull * f, 4ull * d * f};
  const uint32_t wbox[3] = {split::kBN, split::kBK, 1};
  err = encode_f32_map(&tw, w, 3, wdims, wstrides, wbox, kSwizzleNone);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split::gmm_wgmma_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      split::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((C + split::kBM - 1) / split::kBM,
                  (f + split::kBN - 1) / split::kBN, E);
  split::gmm_wgmma_split<<<grid, split::kThreads, split::kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<float*>(out), C, d, f);
  return cudaGetLastError();
}
