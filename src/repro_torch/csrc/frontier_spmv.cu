// K2 frontier_spmv: the edge half of one bulk-peeling round, one fused pass
// over the COO edge slots.
//
// Replaces the two segment_sums, the masked sum and the edge_alive update of
// src/repro/core/peel.py:201-210 (_round_step).  That code is not a Pallas
// kernel, but it moves most of a round's bytes.  Per edge slot i:
//   ps = peel[src], pd = peel[dst], cm = alive ? c : 0
//   ps & !pd  ->  dw[dst] += cm        pd & !ps  ->  dw[src] += cm
//   drop partial += cm  if ps | pd
//   alive' = alive & !(ps | pd)
// dw is zeroed by the wrapper; the drop-mass partials [n_blocks] are summed
// by the wrapper in a fixed order.  The same kernel serves the full buffer
// (pad slots: src = dst = n_capacity-1, c = 0, mask false) and the workset
// (pad lanes: endpoint 0, c = 0, alive false): both are inert, since a dead
// lane is skipped and a self-loop never scatters.
//
// Bound on the H100: memory.  Per slot it streams src, dst, c (4 B each) and
// alive (1 B) and writes alive' (1 B): 14 B/slot, plus the peel mask (1 B) and
// dw (4 B) per vertex, which stay resident in the 50 MB L2 while the random
// gathers and atomics hit them.  At Grab4 (E = 27,500,032, V = 6,023,168)
// that is about 0.42 GB, i.e. about 125 us at 3.35 TB/s.  A slot that is
// already dead reads only its alive byte: it skips the endpoint loads, the
// two peel gathers and the weight load, so late rounds, where most of the
// restricted set is gone, move far fewer bytes than the bound above.
// dw is accumulated with float atomicAdd: exact, hence order-independent, on
// integer weights whose sums stay below 2^24; otherwise it differs from the
// plain version in the last bits from run to run.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(spade::kThreads) frontier_spmv_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ c, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ peel, float* __restrict__ dw,
    uint8_t* __restrict__ alive_out, float* __restrict__ drop_partials,
    int64_t n_edges) {
  __shared__ float scratch[spade::kWarps];
  float drop = 0.f;
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  for (int64_t i = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x;
       i < n_edges; i += stride) {
    uint8_t out = 0;
    if (alive[i]) {
      const int32_t s = src[i];
      const int32_t d = dst[i];
      const bool ps = peel[s] != 0;
      const bool pd = peel[d] != 0;
      if (ps || pd) {
        const float cm = c[i];
        drop += cm;
        if (ps != pd) atomicAdd(dw + (ps ? d : s), cm);
      } else {
        out = 1;
      }
    }
    alive_out[i] = out;
  }
  drop = spade::block_sum(drop, scratch);
  if (threadIdx.x == 0) drop_partials[blockIdx.x] = drop;
}

}  // namespace

extern "C" int frontier_spmv_launch(const void* src, const void* dst,
                                    const void* c, const void* alive,
                                    const void* peel, void* dw,
                                    void* alive_out, void* drop_partials,
                                    int64_t n_edges, int n_blocks,
                                    void* stream) {
  frontier_spmv_kernel<<<n_blocks, spade::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)c,
      (const uint8_t*)alive, (const uint8_t*)peel, (float*)dw,
      (uint8_t*)alive_out, (float*)drop_partials, n_edges);
  return (int)cudaGetLastError();
}
