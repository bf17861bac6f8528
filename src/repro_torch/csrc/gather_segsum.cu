// K4 gather_segsum: destination-row SpMM, out[r] = sum_{e in row r} val[e] * x[col[e]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_segsum/kernel.py
// (block_spmm, pallas_call at line 72), which computes the same out = A x
// from dense 128x128 tiles sorted by destination block: on the TPU an
// element-wise scatter-add is hostile to the MXU, so edges are bucketed into
// tiles and each grid step is one matrix product.  On Hopper the function is
// a gather and a row reduction, and this kernel reads A as destination-sorted
// CSR rows (BlockRows: row_ptr i64 [n_rows + 1], col i32 [nnz], val f32
// [nnz]) instead of tiles that are mostly zeros.
//
// Bound on the H100: bytes.  Each input once: nnz * (4 + 4) for col and val,
// (n_rows + 1) * 8 for row_ptr, n_x * F * 4 for x, n_rows * F * 4 for the
// output, at 3.35 TB/s; 2 * nnz * F FP32 operations are far below 67 TFLOP/s.
// When x outgrows the 50 MB L2 each edge gathers its x row from memory
// (nnz * F * 4 bytes more): the floor of this design without reordering.
//
// Design:
// * a row belongs to a team of G * E lanes inside one warp.  G lanes share
//   one edge's x row, 4 columns a lane (G = 1, 2, 4, 8 for F <= 32; at
//   larger F, G = 32 and the warp loops over 128-column chunks); the E
//   groups of a team take the row's edges strided by E, so E edges are in
//   flight per row, and each group keeps 4 of them in flight more by loading
//   4 cols, vals and x rows before its 4 FFMAs.  The wrapper picks E, a power
//   of two, near a quarter of the mean row length, so short rows (a sampled
//   block's ~1 edge a row) get one group and ogbn-products' ~25 get four.
// * x rows are read through the read-only path (__ldg): 16-byte loads when
//   F % 4 == 0 and x is 16-byte aligned, scalar loads otherwise (F = 7).
//   A col outside [0, n_x) reads as a zero row.
// * each group sums its edges in order with FFMA; the team's E groups are
//   combined with a fixed xor-shuffle tree, and group 0 writes the row once:
//   no atomics, the same bits on every run, exact on integer values.
// * 128-thread CTAs; on a small graph the wrapper raises E until there are
//   two CTAs per SM, so Cora's 3,072 rows give 384 CTAs on 132 SMs.
// Later work: a merge-path split of power-law rows across warps, and a
// degree-sorted reordering of the nodes so that x rows are reused in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // edges in flight per group

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// The 4 columns [c, c + 4) of x row s (zeros past F or for a row outside x).
template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int32_t s,
                                         int64_t n_x, int F, int c, float (&v)[4]) {
  const bool ok = s >= 0 && (int64_t)s < n_x && c < F;
  const float* p = x + (int64_t)s * F + c;
  if (VEC) {
    // F % 4 == 0, so c < F covers all four columns
    const float4 q =
        ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (ok && c + j < F) ? __ldg(p + j) : 0.f;
  }
}

template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads) gather_segsum_kernel(
    const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const float* __restrict__ val, const float* __restrict__ x, float* __restrict__ out,
    int64_t n_rows, int64_t n_x, int F, int e_log2) {
  const int E = 1 << e_log2;            // groups (edges in flight) per row
  const int team = G * E;               // lanes per row, a power of two <= 32
  const int t = threadIdx.x & (team - 1);
  const int grp = t / G;
  const int sub = t % G;
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> (e_log2 + log2i(G));
  const bool live = row < n_rows;
  const int64_t begin = live ? row_ptr[row] : 0;
  const int64_t end = live ? row_ptr[row + 1] : 0;
  for (int c0 = 0; c0 < F; c0 += 4 * G) {  // one pass when F <= 4 * G
    const int c = c0 + 4 * sub;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int64_t e = begin + grp;
    for (; e + (kUnroll - 1) * E < end; e += kUnroll * E) {
      int32_t s[kUnroll];
      float w[kUnroll], v[kUnroll][4];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        s[k] = __ldg(col + e + k * E);
        w[k] = __ldg(val + e + k * E);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) load_row<VEC>(x, s[k], n_x, F, c, v[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(w[k], v[k][j], acc[j]);
      }
    }
    for (; e < end; e += E) {
      float v[4];
      const float w = __ldg(val + e);
      load_row<VEC>(x, __ldg(col + e), n_x, F, c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(w, v[j], acc[j]);
    }
    // the team's groups, combined by a tree fixed by (G, E); every lane of
    // the warp takes part (team is uniform, the loop above has reconverged)
    for (int o = G; o < team; o <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    if (live && grp == 0 && c < F) {
      float* dst = out + row * F + c;
      if (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < F) dst[j] = acc[j];
      }
    }
  }
}

template <int G, bool VEC>
int launch(const int64_t* row_ptr, const int32_t* col, const float* val, const float* x,
           float* out, int64_t n_rows, int64_t n_x, int F, int e_log2, cudaStream_t stream) {
  const int64_t threads = n_rows * ((int64_t)G << e_log2);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_segsum_kernel<G, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      row_ptr, col, val, x, out, n_rows, n_x, F, e_log2);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch(int G, const int64_t* rp, const int32_t* c, const float* v, const float* x,
             float* o, int64_t n_rows, int64_t n_x, int F, int e_log2, cudaStream_t st) {
  switch (G) {
    case 1: return launch<1, VEC>(rp, c, v, x, o, n_rows, n_x, F, e_log2, st);
    case 2: return launch<2, VEC>(rp, c, v, x, o, n_rows, n_x, F, e_log2, st);
    case 4: return launch<4, VEC>(rp, c, v, x, o, n_rows, n_x, F, e_log2, st);
    case 8: return launch<8, VEC>(rp, c, v, x, o, n_rows, n_x, F, e_log2, st);
    case 32: return launch<32, VEC>(rp, c, v, x, o, n_rows, n_x, F, e_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// row_ptr: [n_rows + 1] i64 (the first n_rows + 1 entries of the matrix's);
// col: [nnz] i32; val: [nnz] f32; x: [n_x, F] f32; out: [n_rows, F] f32; all
// contiguous.  G lanes per edge (1, 2, 4, 8 or 32), E edges per row in
// flight (a power of two, G * E <= 32); vec: 16-byte loads (F % 4 == 0 and
// x 16-byte aligned).  Returns a cudaError_t (0 = ok).
extern "C" int gather_segsum_launch(const void* row_ptr, const void* col, const void* val,
                                    const void* x, void* out, int64_t n_rows, int64_t n_x,
                                    int F, int G, int E, int vec, void* stream) {
  if (n_rows <= 0 || n_x <= 0 || F <= 0 || E <= 0 || (E & (E - 1)) || G * E > 32 ||
      (G < 32 && F > 4 * G))
    return (int)cudaErrorInvalidValue;
  const int e_log2 = __builtin_ctz((unsigned)E);
  auto rp = (const int64_t*)row_ptr;
  auto c = (const int32_t*)col;
  auto v = (const float*)val;
  auto xp = (const float*)x;
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  if (vec) return dispatch<true>(G, rp, c, v, xp, o, n_rows, n_x, F, e_log2, st);
  return dispatch<false>(G, rp, c, v, xp, o, n_rows, n_x, F, e_log2, st);
}
