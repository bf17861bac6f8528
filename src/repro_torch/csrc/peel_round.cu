// K1 peel_round: the elementwise half of one bulk-peeling round.
//
// Replaces the Pallas TPU kernel src/repro/kernels/peel_round/kernel.py
// (peel_round_update, pallas_call at line 76).  Per vertex:
//   peeled  = active & (w <= thresh)
//   w'      = w - dw
//   active' = active & ~peeled
//   level'  = peeled ? round : level
// and per block the partials [sum peeled*a, sum peeled*w (pre-update w),
// n_peeled] into partials[n_blocks][3], summed over blocks by the wrapper in
// a fixed order (no atomics, so the sums are deterministic).
//
// Bound on the H100: memory.  Per vertex it reads w, level (4 B each), dw
// (8 B), active (1 B) and, for peeled vertices only, a (4 B); it writes w',
// level' (4 B each), active', peeled (1 B each) and, where dw was not 0,
// a zero (8 B): about 27-39 B/vertex, i.e. about 0.16-0.23 GB at
// V = 6,023,168 (Grab4), about 49-70 us at 3.35 TB/s.  The
// operation count (a compare and a subtract) is negligible.  The design is
// one coalesced grid-stride pass: neighbouring threads touch neighbouring
// addresses, each array is read once, and the threshold and round number
// are read from device memory (thresh = 2(1+eps)*g is computed once in
// torch and passed by pointer, so the host never syncs and the kernel never
// recomputes it in another order).  Vectorised 16-byte loads are left for
// a later change.
//
// dw is K2's float64 accumulator (frontier_spmv.cu), rounded to float32
// once, on load.  The kernel writes 0 back where dw was not 0, so the
// peel's accumulator is zero again for the next round without a memset.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(spade::kThreads) peel_round_kernel(
    const float* __restrict__ w, const float* __restrict__ a,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ level,
    double* __restrict__ dw, const float* __restrict__ thresh,
    const int32_t* __restrict__ round_, float* __restrict__ w_out,
    uint8_t* __restrict__ active_out, int32_t* __restrict__ level_out,
    uint8_t* __restrict__ peeled_out, float* __restrict__ partials,
    int64_t n) {
  __shared__ float scratch[spade::kWarps];
  const float th = *thresh;
  const int32_t r = *round_;
  float sa = 0.f, sw = 0.f, sn = 0.f;
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  for (int64_t i = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x; i < n;
       i += stride) {
    const float wi = w[i];
    const bool act = active[i] != 0;
    const bool p = act && (wi <= th);
    const double d = dw[i];
    w_out[i] = wi - __double2float_rn(d);
    if (d != 0.0) dw[i] = 0.0;
    active_out[i] = (uint8_t)(act && !p);
    level_out[i] = p ? r : level[i];
    peeled_out[i] = (uint8_t)p;
    if (p) {
      sa += a[i];
      sw += wi;
      sn += 1.f;
    }
  }
  sa = spade::block_sum(sa, scratch);
  sw = spade::block_sum(sw, scratch);
  sn = spade::block_sum(sn, scratch);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = sa;
    partials[3 * blockIdx.x + 1] = sw;
    partials[3 * blockIdx.x + 2] = sn;
  }
}

}  // namespace

// `dw` a float64 [V], left all zero.
extern "C" int peel_round_launch(const void* w, const void* a,
                                 const void* active, const void* level,
                                 void* dw, const void* thresh,
                                 const void* round_, void* w_out,
                                 void* active_out, void* level_out,
                                 void* peeled_out, void* partials, int64_t n,
                                 int n_blocks, void* stream) {
  peel_round_kernel<<<n_blocks, spade::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)a, (const uint8_t*)active, (const int32_t*)level,
      (double*)dw, (const float*)thresh, (const int32_t*)round_, (float*)w_out,
      (uint8_t*)active_out, (int32_t*)level_out, (uint8_t*)peeled_out, (float*)partials, n);
  return (int)cudaGetLastError();
}
