// K4 gather_segsum: block-sparse SpMM, out[tile_dst[t]] += tiles[t] @ x[tile_src[t]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_segsum/kernel.py
// (block_spmm, pallas_call at line 72).  Same contract: dense 128x128 f32
// tiles A[dst_local, src_local] sorted by destination block, every output
// block visited (zero tiles for empty blocks), f32 arithmetic throughout.
//
// Bound on the H100: bytes at the GCN widths.  A launch reads each tile once
// (64 KB), an x block per tile (128 * F * 4 B) and writes the output once:
// T * 128^2 * 4 + T * 128 * F * 4 + n_out * F * 4 bytes, at 3.35 TB/s.  It
// does 2 * T * 128^2 * F flops in FP32 (no tensor cores: TF32 would miss the
// 1e-4 contract), at 67 TFLOP/s; F >= ~40 makes it operations-bound.  Tiles
// of a sparse graph are mostly zeros, so the bytes are those of the tile
// format, not of the edges.
//
// Design (a simple first kernel, not the TPU grid):
// * one CTA of 256 threads per (destination block, column tile of FT = 16,
//   32 or 64 columns).  The TPU's sequential tile axis, which carried the
//   output block in VMEM from step to step, becomes a loop inside the CTA
//   over the block's run of tiles [run_start[b], run_start[b + 1]); the
//   128 x FT accumulator stays in registers (thread: one row, FT / 2
//   columns) and the block is written once, so no first-visit flag and no
//   atomics are needed, and the order of every sum is fixed: repeated runs
//   give the same bits.
// * each tile (64 KB) and its x block are staged in shared memory by
//   cp.async, double buffered (the next tile loads while this one is
//   used).  Tile rows keep their 16-byte chunks XOR-swizzled by (row & 7),
//   so the float4 reads of 8 consecutive rows hit 8 distinct bank groups.
// * x is read in place: rows past n_x_rows and columns past F are
//   zero-filled by cp.async (no padded copy); rows past n_out_rows and
//   columns past F are not written.  Tile offsets are int64 (T * 128^2
//   passes 2^31 at T >= 131,072).
// * FFMA on f32, k in increasing order within a tile, tiles in run order.
// A CTA needs 144-192 KB of shared memory, so one runs per SM; a graph with
// fewer output blocks than SMs leaves SMs idle.  Tensor cores (3xTF32),
// TMA and a split of long runs across CTAs are left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;  // tile edge
constexpr int kThreads = 256;
constexpr int kTileFloats = kBS * kBS;
constexpr int kTileChunks = kTileFloats / 4;  // 16-byte chunks per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
// 4-byte global->shared copy; writes a zero when !pred (src must still be a
// valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int FT>
constexpr int smem_bytes() {
  return 2 * (kTileFloats + kBS * FT) * (int)sizeof(float);
}

template <int FT>
__global__ void __launch_bounds__(kThreads, 1) block_spmm_kernel(
    const float* __restrict__ tiles, const int32_t* __restrict__ tile_src,
    const int64_t* __restrict__ run_start, const float* __restrict__ x,
    float* __restrict__ out, int64_t n_x_rows, int F, int64_t n_out_rows) {
  constexpr int kCols = FT / 2;  // columns per thread
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                    // [2][kBS * kBS], chunk-swizzled rows
  float* x_s = smem + 2 * kTileFloats;  // [2][kBS][FT]
  const int tid = threadIdx.x;
  const int r = tid & (kBS - 1);  // output row of this thread
  const int c0 = (tid >> 7) * kCols;  // its first column within the tile
  const int f0 = blockIdx.y * FT;
  const int64_t t_begin = run_start[blockIdx.x];
  const int64_t t_end = run_start[blockIdx.x + 1];

  auto stage = [&](int64_t t, int buf) {
    const float* src = tiles + t * (int64_t)kTileFloats;
    float* dst = a_s + buf * kTileFloats;
#pragma unroll
    for (int i = 0; i < kTileChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 5, g = c & 31;
      cp_async16(dst + (row * 32 + (g ^ (row & 7))) * 4, src + (int64_t)c * 4);
    }
    const int64_t row0 = (int64_t)tile_src[t] * kBS;
    float* xd = x_s + buf * kBS * FT;
#pragma unroll
    for (int i = 0; i < kBS * FT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int64_t row = row0 + e / FT;
      const int col = f0 + e % FT;
      const bool ok = row >= 0 && row < n_x_rows && col < F;
      cp_async4(xd + e, ok ? x + row * F + col : x, ok);
    }
    cp_async_commit();
  };

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  if (t_begin < t_end) stage(t_begin, 0);
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int buf = (int)((t - t_begin) & 1);
    if (t + 1 < t_end) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* a_row = reinterpret_cast<const float4*>(a_s + buf * kTileFloats) + r * 32;
    const float* xb = x_s + buf * kBS * FT + c0;
#pragma unroll 2
    for (int g = 0; g < 32; ++g) {
      const float4 a4 = a_row[g ^ (r & 7)];
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4* xr = reinterpret_cast<const float4*>(xb + (4 * g + kk) * FT);
#pragma unroll
        for (int j = 0; j < kCols / 4; ++j) {
          const float4 v = xr[j];
          acc[4 * j + 0] = fmaf(a[kk], v.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(a[kk], v.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(a[kk], v.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(a[kk], v.w, acc[4 * j + 3]);
        }
      }
    }
    __syncthreads();  // the next iteration's stage overwrites this buffer's twin
  }

  const int64_t row = (int64_t)blockIdx.x * kBS + r;
  if (row < n_out_rows) {
    float* o = out + row * F;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = f0 + c0 + j;
      if (col < F) o[col] = acc[j];
    }
  }
}

template <int FT>
int launch(const float* tiles, const int32_t* tile_src, const int64_t* run_start,
           const float* x, float* out, int64_t n_out_blocks, int64_t n_x_rows, int F,
           int64_t n_out_rows, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(block_spmm_kernel<FT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<FT>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)n_out_blocks, (unsigned)((F + FT - 1) / FT));
  block_spmm_kernel<FT><<<grid, kThreads, smem_bytes<FT>(), stream>>>(
      tiles, tile_src, run_start, x, out, n_x_rows, F, n_out_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles: [T, 128, 128] f32; tile_src: [T] i32; run_start: [n_out_blocks + 1]
// i64; x: [n_x_rows, F] f32; out: [n_out_rows, F] f32; all contiguous.
// Returns a cudaError_t (0 = ok).
extern "C" int gather_segsum_launch(const void* tiles, const void* tile_src,
                                    const void* run_start, const void* x, void* out,
                                    int64_t n_out_blocks, int64_t n_x_rows, int F,
                                    int64_t n_out_rows, void* stream) {
  if (n_out_blocks <= 0 || n_out_blocks > 0x7fffffff || F <= 0 || n_x_rows <= 0)
    return (int)cudaErrorInvalidValue;
  auto t = (const float*)tiles;
  auto s = (const int32_t*)tile_src;
  auto rs = (const int64_t*)run_start;
  auto xp = (const float*)x;
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  if (F <= 16) return launch<16>(t, s, rs, xp, o, n_out_blocks, n_x_rows, F, n_out_rows, st);
  if (F <= 32) return launch<32>(t, s, rs, xp, o, n_out_blocks, n_x_rows, F, n_out_rows, st);
  return launch<64>(t, s, rs, xp, o, n_out_blocks, n_x_rows, F, n_out_rows, st);
}
