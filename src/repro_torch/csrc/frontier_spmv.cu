// K2: the edge pass of bulk peeling, two entries over the COO edge slots.
//
// Round entry (frontier_spmv_launch) replaces the two segment_sums, the
// masked sum and the edge_alive update of src/repro/core/peel.py:201-210
// (_round_step).  Per live slot i, with ps = peel[src], pd = peel[dst]:
//   ps & !pd -> dw[dst] += c    pd & !ps -> dw[src] += c
//   drop += c  if ps | pd;      alive[i] = 0  if ps | pd  (in place)
// Prologue entry (suffix_init_launch) replaces the warm peel's induced
// weights, src/repro/core/peel.py:324-329 (bulk_peel_warm):
//   both[i] = live[src] & live[dst] & edge_mask[i]
//   w0 = where(live, a, 0) + both-masked c scattered to both ends
//   f0 = sum where(live, a, 0) + sum both * c
// Neither is a Pallas kernel, but together they are the peel's edge traffic.
// Pad slots (full buffer: src = dst = n_capacity-1, c = 0, not live;
// workset: endpoint 0, c = 0, not live) are inert in both.
//
// Bound on the H100: bytes.  A round must read alive (1 B a slot), src and
// dst of live slots (8 B), c of hit slots (4 B) and peel (1 B a vertex), and
// write dw and the cleared alive bytes.  The dense rounds add L2 traffic the
// bytes bound does not count: each random 1-byte peel gather and each dw
// atomic moves a 32-byte L2 sector.  The prologue reads src, dst, c,
// edge_mask (13 B a slot) and live, a (5 B a vertex) and writes both (1 B a
// slot) and w0 (4 B a vertex), with the same gathers and atomics.
//
// What the loop does about it.  A thread owns kSlots consecutive slots and
// reads their liveness bytes in one 16-byte load, so a warp keeps 512 bytes
// in flight per load where a byte-per-thread loop kept 32.  A group with no
// live slot costs those bytes and nothing else (no endpoint loads, gathers
// or store), so a round after convergence reads E bytes and writes none.  A
// group with live slots loads src/dst as 16-byte vectors and issues all its
// gathers before it uses any, so kSlots requests per thread are in flight;
// it loads c only for hit slots and stores its liveness once, only if it
// changed.  The prologue reads its streamed arrays with evict-first loads,
// so the accumulator's share keeps the L2.  Slots before the first
// 16-byte boundary of alive, and the tail, take a scalar path in the same
// kernel; the wrapper sends every slot there when the arrays cannot be read
// as vectors.  The drop (or f0) partials of the blocks are summed by the last
// block to finish (a threadfence and a ticket) in block order with
// spade::block_sum, so there is no separate sum launch.
//
// Same bits on every run.  dw and w0 are scattered with float64 atomicAdd
// into a float64 accumulator holding zeros: a vertex's float32
// contributions, added in any order, give a float64 sum within a few float64
// ulps of the exact one, and it is rounded to float32 once (dw by K1 on
// load, w0 by the vertex pass), so the float32 result is the same every run
// (it could differ only where the exact sum lies within those ulps of a
// float32 rounding point).  A peel keeps one dw accumulator for all its
// rounds and K1 writes back zero where it read a value, so a round needs no
// memset, and its block ticket is reset by the last block, so no launch
// but the kernel's own.
// Float32 atomics differ in the last bit from run to run, and the peel's
// threshold test turns such a bit into a different peel order when a
// weight ties the threshold to one ulp, which a Grab4 tick meets (PERF.md).
// On integer weights whose sums stay below 2^24 both are exact, hence equal
// to the plain versions.  The accumulator is 8 B a vertex: the prologue adds
// into it in passes over vertex ranges that each fit half the L2.
#include "common.cuh"

namespace {

constexpr int kVec = 16;  // bytes of one vector load
constexpr int kSlots = kVec;  // edge slots a thread: one 16-byte liveness load

__device__ __forceinline__ bool byte_of(const uint32_t* words, int j) {
  return (words[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// Fixed-order sum of p[0, n) over the block: each thread a strided run,
// then block_sum.  Valid in thread 0.
__device__ __forceinline__ float ordered_sum(const float* p, int n, float* scratch) {
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += spade::kThreads) t += __ldcg(p + i);
  return spade::block_sum(t, scratch);
}

// Writes this block's sum of v to partials[blockIdx.x]; returns true in
// every thread of the last block to finish, which may then read all the
// partials.  `ticket` starts at 0 and ends at gridDim.x.
__device__ __forceinline__ bool last_block(float v, float* partials, unsigned* ticket,
                                           float* scratch) {
  __shared__ bool last;
  v = spade::block_sum(v, scratch);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Slot k of the scalar path: the head [0, head), then the tail after the
// vector groups.
__device__ __forceinline__ int64_t scalar_slot(int64_t k, int64_t head, int64_t vec_end) {
  return k < head ? k : vec_end + (k - head);
}

__global__ void __launch_bounds__(spade::kThreads, 3) frontier_spmv_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ c, uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ peel, double* __restrict__ dw,
    float* __restrict__ partials, unsigned* __restrict__ ticket,
    float* __restrict__ drop_out, int64_t n_edges, int64_t head, int64_t n_groups) {
  __shared__ float scratch[spade::kWarps];
  float drop = 0.f;
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  const int64_t tid = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x;
  for (int64_t g = tid; g < n_groups; g += stride) {
    const int64_t base = head + g * kSlots;
    const uint4 v = *reinterpret_cast<const uint4*>(alive + base);
    uint32_t a[4] = {v.x, v.y, v.z, v.w};
    if (!(a[0] | a[1] | a[2] | a[3])) continue;  // a dead group: 16 bytes read, nothing else
    int32_t s[kSlots], d[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots / 4; ++q) {
      const int4 vs = reinterpret_cast<const int4*>(src + base)[q];
      const int4 vd = reinterpret_cast<const int4*>(dst + base)[q];
      s[4 * q] = vs.x, s[4 * q + 1] = vs.y, s[4 * q + 2] = vs.z, s[4 * q + 3] = vs.w;
      d[4 * q] = vd.x, d[4 * q + 1] = vd.y, d[4 * q + 2] = vd.z, d[4 * q + 3] = vd.w;
    }
    // every gather of the group before any use
    bool ps[kSlots], pd[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool live = byte_of(a, j);
      ps[j] = live && __ldg(peel + s[j]);
      pd[j] = live && __ldg(peel + d[j]);
    }
    float cm[kSlots];
    uint32_t hit = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool h = ps[j] || pd[j];
      hit |= (uint32_t)h << j;
      cm[j] = h ? c[base + j] : 0.f;
    }
    if (!hit) continue;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      drop += cm[j];
      if (ps[j] != pd[j]) atomicAdd(dw + (ps[j] ? d[j] : s[j]), (double)cm[j]);
      if ((hit >> j) & 1u) a[j >> 2] &= ~(0xffu << (8 * (j & 3)));
    }
    *reinterpret_cast<uint4*>(alive + base) = make_uint4(a[0], a[1], a[2], a[3]);
  }
  const int64_t vec_end = head + n_groups * kSlots;
  const int64_t n_scalar = head + (n_edges - vec_end);
  for (int64_t k = tid; k < n_scalar; k += stride) {
    const int64_t i = scalar_slot(k, head, vec_end);
    if (!alive[i]) continue;
    const int32_t si = src[i], di = dst[i];
    const bool p1 = __ldg(peel + si), p2 = __ldg(peel + di);
    if (!(p1 || p2)) continue;
    const float cm = c[i];
    drop += cm;
    if (p1 != p2) atomicAdd(dw + (p1 ? di : si), (double)cm);
    alive[i] = 0;
  }
  if (last_block(drop, partials, ticket, scratch)) {
    const float total = ordered_sum(partials, gridDim.x, scratch);
    if (threadIdx.x == 0) {
      *drop_out = total;
      *ticket = 0u;  // every block has taken its ticket: ready for the next launch
    }
  }
}

__device__ __forceinline__ bool in_range(int32_t v, int32_t lo, int32_t hi) {
  return (uint32_t)(v - lo) < (uint32_t)(hi - lo);
}

// One pass over the slots, adding the both-masked c of each slot to acc at
// each end that lies in [lo, hi).  The first pass (`first`) decides both
// (gathering live at the ends of edge_mask's slots), writes it, sums the
// block's both-masked c into partials[blockIdx.x] and resets the vertex
// kernel's ticket; a later pass reads both back instead.
__global__ void __launch_bounds__(spade::kThreads) suffix_init_edges_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ c, const uint8_t* __restrict__ emask,
    const uint8_t* __restrict__ live, double* __restrict__ acc,
    uint8_t* __restrict__ both, float* __restrict__ partials,
    unsigned* __restrict__ ticket, int64_t n_edges, int64_t n_groups,
    int32_t lo, int32_t hi, int first) {
  __shared__ float scratch[spade::kWarps];
  float sum = 0.f;
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  const int64_t tid = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x;
  for (int64_t g = tid; g < n_groups; g += stride) {
    const int64_t base = g * kSlots;
    const uint4 mv = __ldcs(reinterpret_cast<const uint4*>((first ? emask : both) + base));
    uint32_t m[4] = {mv.x, mv.y, mv.z, mv.w};
    uint32_t out[4] = {0u, 0u, 0u, 0u};
    if (m[0] | m[1] | m[2] | m[3]) {
      int32_t s[kSlots], d[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots / 4; ++q) {
        const int4 vs = __ldcs(reinterpret_cast<const int4*>(src + base) + q);
        const int4 vd = __ldcs(reinterpret_cast<const int4*>(dst + base) + q);
        s[4 * q] = vs.x, s[4 * q + 1] = vs.y, s[4 * q + 2] = vs.z, s[4 * q + 3] = vs.w;
        d[4 * q] = vd.x, d[4 * q + 1] = vd.y, d[4 * q + 2] = vd.z, d[4 * q + 3] = vd.w;
      }
      // both gathers of every slot before any use
      bool bt[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const bool mj = byte_of(m, j);
        if (first) {
          const uint8_t ls = mj ? __ldg(live + s[j]) : 0;
          const uint8_t ld = mj ? __ldg(live + d[j]) : 0;
          bt[j] = ls && ld;
        } else {
          bt[j] = mj;
        }
      }
      float cm[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) cm[j] = bt[j] ? __ldcs(c + base + j) : 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (bt[j]) {
          if (in_range(s[j], lo, hi)) atomicAdd(acc + s[j], (double)cm[j]);
          if (in_range(d[j], lo, hi)) atomicAdd(acc + d[j], (double)cm[j]);
          sum += cm[j];
          out[j >> 2] |= 1u << (8 * (j & 3));
        }
      }
    }
    if (first) *reinterpret_cast<uint4*>(both + base) = make_uint4(out[0], out[1], out[2], out[3]);
  }
  for (int64_t i = n_groups * kSlots + tid; i < n_edges; i += stride) {
    bool b = false;
    if (first ? emask[i] : both[i]) {
      const int32_t si = src[i], di = dst[i];
      b = !first || (live[si] && live[di]);
      if (b) {
        const float cm = c[i];
        if (in_range(si, lo, hi)) atomicAdd(acc + si, (double)cm);
        if (in_range(di, lo, hi)) atomicAdd(acc + di, (double)cm);
        sum += cm;
      }
    }
    if (first) both[i] = b;
  }
  if (first) {
    sum = spade::block_sum(sum, scratch);
    if (threadIdx.x == 0) {
      partials[blockIdx.x] = sum;
      if (blockIdx.x == 0) *ticket = 0u;
    }
  }
}

// w0[v] = live ? a + acc : 0, rounded to float32 once; the last block to
// finish adds the vertex and edge sums into f0 in block order.
__global__ void __launch_bounds__(spade::kThreads) suffix_init_vertices_kernel(
    const uint8_t* __restrict__ live, const float* __restrict__ a,
    const double* __restrict__ acc, float* __restrict__ w0,
    float* __restrict__ vpartials, const float* __restrict__ epartials, int n_eblocks,
    unsigned* __restrict__ ticket, float* __restrict__ f0_out, int64_t n) {
  __shared__ float scratch[spade::kWarps];
  float sum = 0.f;
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  for (int64_t v = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x; v < n; v += stride) {
    float x = 0.f;
    if (live[v]) {
      sum += a[v];
      x = __double2float_rn((double)a[v] + acc[v]);
    }
    w0[v] = x;
  }
  if (last_block(sum, vpartials, ticket, scratch)) {
    const float vsum = ordered_sum(vpartials, gridDim.x, scratch);
    const float esum = ordered_sum(epartials, n_eblocks, scratch);
    if (threadIdx.x == 0) *f0_out = vsum + esum;
  }
}

// Blocks of kThreads for `work` items (vector groups plus scalar slots):
// one wave of the blocks the kernel can keep resident, at most `cap`.  The
// resident count is asked once per kernel and device.
int grid_for(const void* kernel, int64_t work, int cap) {
  struct Entry { const void* kernel; int dev; int blocks; };
  static Entry known[32];
  static int n_known = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int most = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].dev == dev) most = known[i].blocks;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, spade::kThreads, 0);
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (n_known < 32) known[n_known++] = {kernel, dev, most};
  }
  int64_t want = (work + spade::kThreads - 1) / spade::kThreads;
  if (want > most) want = most;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

}  // namespace

// The round.  `dw` a float64 [V] accumulator holding zeros, which the round
// adds into; `ticket` a uint32 holding 0, left 0; `partials` room for `cap`
// floats; `alive` is updated in place.  Vector groups of 16 slots
// cover [head, head + 16 * n_groups).
extern "C" int frontier_spmv_launch(const void* src, const void* dst, const void* c,
                                    void* alive, const void* peel, void* dw,
                                    void* partials, void* ticket, void* drop,
                                    int64_t n_edges, int64_t head, int64_t n_groups,
                                    int cap, void* stream) {
  const int nb = grid_for((const void*)frontier_spmv_kernel,
                          n_groups + head + (n_edges - head - n_groups * kSlots), cap);
  frontier_spmv_kernel<<<nb, spade::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)c, (uint8_t*)alive,
      (const uint8_t*)peel, (double*)dw, (float*)partials, (unsigned*)ticket, (float*)drop,
      n_edges, head, n_groups);
  return (int)cudaGetLastError();
}

// The warm peel's prologue: `n_parts` passes over the slots, each adding
// into the ends in one range of vertices (so that the float64 accumulator's
// share stays in L2 while the slots stream by), then one vertex pass.
// `acc` is a zeroed float64 [V]; `vpartials` and `partials` hold room for
// `cap` floats each.  Vector groups of 16 slots cover [0, 16 * n_groups).
extern "C" int suffix_init_launch(const void* src, const void* dst, const void* c,
                                  const void* emask, const void* live, const void* a,
                                  void* acc, void* w0, void* both, void* vpartials,
                                  void* partials, void* ticket, void* f0, int64_t n_edges,
                                  int64_t n_vertices, int64_t n_groups, int n_parts, int cap,
                                  void* stream) {
  auto st = (cudaStream_t)stream;
  const int nbe = grid_for((const void*)suffix_init_edges_kernel,
                           n_groups + (n_edges - n_groups * kVec), cap);
  for (int p = 0; p < n_parts; ++p) {
    const int32_t lo = (int32_t)(n_vertices * p / n_parts);
    const int32_t hi = (int32_t)(n_vertices * (p + 1) / n_parts);
    suffix_init_edges_kernel<<<nbe, spade::kThreads, 0, st>>>(
        (const int32_t*)src, (const int32_t*)dst, (const float*)c, (const uint8_t*)emask,
        (const uint8_t*)live, (double*)acc, (uint8_t*)both, (float*)partials,
        (unsigned*)ticket, n_edges, n_groups, lo, hi, p == 0);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int nbv = grid_for((const void*)suffix_init_vertices_kernel, n_vertices, cap);
  suffix_init_vertices_kernel<<<nbv, spade::kThreads, 0, st>>>(
      (const uint8_t*)live, (const float*)a, (const double*)acc, (float*)w0,
      (float*)vpartials, (const float*)partials, nbe, (unsigned*)ticket, (float*)f0,
      n_vertices);
  return (int)cudaGetLastError();
}
