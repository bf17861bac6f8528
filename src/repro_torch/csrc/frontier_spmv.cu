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
// slot) and w0 (4 B a vertex), with the same gathers; its binned scatter
// adds the pair buffer, 8 B a pair written and read once (two pairs a both
// slot), and reads src and dst again.
//
// What the loop does about it.  A thread owns kSlots consecutive slots and
// reads their liveness bytes in one 16-byte load, so a warp keeps 512 bytes
// in flight per load where a byte-per-thread loop kept 32.  A group with no
// live slot costs those bytes and nothing else (no endpoint loads, gathers
// or store), so a round after convergence reads E bytes and writes none.  A
// group with live slots loads src/dst as 16-byte vectors and issues all its
// gathers before it uses any, so kSlots requests per thread are in flight;
// it loads c only for hit slots and stores its liveness once, only if it
// changed.  The prologue's passes read their streamed arrays with
// evict-first loads; it sends no float atomic to global memory (the binned
// scatter below).  Slots before the first
// 16-byte boundary of alive, and the tail, take a scalar path in the same
// kernel; the wrapper sends every slot there when the arrays cannot be read
// as vectors.  The drop (or f0) partials of the blocks are summed by the last
// block to finish (a threadfence and a ticket) in block order with
// spade::block_sum, so there is no separate sum launch.
//
// Same bits on every run.  dw is scattered with float64 atomicAdd into a
// float64 accumulator holding zeros, and w0 is added in a float64
// accumulator in shared memory: a vertex's float32 contributions, added in
// any order, give a float64 sum within a few float64 ulps of the exact one,
// and it is rounded to float32 once (dw by K1 on load, w0 by the bins
// kernel), so the float32 result is the same every run (it could differ
// only where the exact sum lies within those ulps of a float32 rounding
// point).  A peel keeps one dw accumulator for all its rounds and K1 writes
// back zero where it read a value, so a round needs no memset, and its
// block ticket is reset by the last block, so no launch but the kernel's own.
// Float32 atomics differ in the last bit from run to run, and the peel's
// threshold test turns such a bit into a different peel order when a
// weight ties the threshold to one ulp, which a Grab4 tick meets (PERF.md).
// On integer weights whose sums stay below 2^24 both are exact, hence equal
// to the plain versions.
#include "common.cuh"

namespace {

constexpr int kVec = 16;  // bytes of one vector load
constexpr int kSlots = kVec;  // edge slots a thread: one 16-byte liveness load

__device__ __forceinline__ bool byte_of(const uint32_t* words, int j) {
  return (words[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// Fixed-order sum of p[0, n) over a block of NW warps: each thread a
// strided run, then the block sum.  Valid in thread 0.
template <int NW = spade::kWarps>
__device__ __forceinline__ float ordered_sum(const float* p, int n, float* scratch) {
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += 32 * NW) t += __ldcg(p + i);
  return spade::block_sum_of<NW>(t, scratch);
}

// Writes this block's sum of v to partials[blockIdx.x]; returns true in
// every thread of the last block to finish, which may then read all the
// partials.  `ticket` starts at 0 and ends at gridDim.x.
template <int NW = spade::kWarps>
__device__ __forceinline__ bool last_block(float v, float* partials, unsigned* ticket,
                                           float* scratch) {
  __shared__ bool last;
  v = spade::block_sum_of<NW>(v, scratch);
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

// ---------------------------------------------------------------------------
// The prologue: a scatter binned through shared memory.  Vertices fall into
// bins of 2^shift consecutive ids, whose float64 sums fit one CTA's shared
// memory.  Three kernels, no float atomic in global memory:
//   count   one pass over the slots: decides both (gathering live at the
//           ends of edge_mask's slots), writes it, and counts each bin's
//           pairs (two a both slot, one at each end) in a shared histogram;
//           the last block turns the counts into each bin's region of the
//           pair buffer (an exclusive scan) and sets the bins' cursors;
//   scatter a pass over the slots in batches of kBatch: each batch's pairs
//           (vertex, c) are sorted by bin in shared memory, each bin's run
//           claims its space with one cursor atomic, and the runs are
//           written out contiguously; the blocks' both-masked c sums are
//           the edge partials of f0;
//   bins    one CTA a bin: zero a float64 accumulator in shared memory, add
//           the bin's pairs into it with shared atomics (a CAS loop on
//           sm_90a; int64 fixed point would be native, but no fixed point
//           holds every float32 exactly), and write
//           w0 = live ? float(double(a) + acc) : 0, coalesced; the last
//           block sums the vertex and edge partials into f0 in block order.
// The float64 mode (acc64 not null) writes the accumulators instead, for
// an edge-sharded peel that adds the ranks' sums before it rounds:
// acc64[v] = acc (no a, not rounded; 0 off live), acc64[V] = the edge sum
// of f0 (the float32 block-order sum, widened), f0 = the vertex sum alone;
// w0 is not written.
// The counts, cursors and tickets are left 0 (as the round's ticket); the
// pair buffer is scratch the wrapper keeps per device.

constexpr int kScatterSlots = 16;  // slots a thread per scatter batch: one 16-byte both load
constexpr int kBinThreads = 1024;  // threads of a bins CTA: two CTAs fill an SM's 64 warps
constexpr int kMaxShift = 13;  // bins of at most 8,192 vertices: 64 KB of float64
constexpr int kMaxBins = 8192;  // so V <= 2^26
constexpr int kBatch = spade::kThreads * kScatterSlots;

// Exclusive prefix of v over the block (threads in order) and the block's
// total; `tmp` holds kWarps + 1 uint32s of shared memory.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* tmp,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = 0;
    for (int w = 0; w < spade::kWarps; ++w) {
      const uint32_t t = tmp[w];
      tmp[w] = run;
      run += t;
    }
    tmp[spade::kWarps] = run;
  }
  __syncthreads();
  const uint32_t out = tmp[warp] + x - v;
  *total = tmp[spade::kWarps];
  __syncthreads();  // tmp may be reused by the next call
  return out;
}

// Exclusive scan of cnt[0, n) into start[0, n] (start[n] = the total),
// consecutive runs of bins a thread.
__device__ __forceinline__ void scan_bins(const uint32_t* cnt, uint32_t* start, int n,
                                          uint32_t* tmp) {
  const int per = (n + spade::kThreads - 1) / spade::kThreads;
  const int b0 = min(n, (int)threadIdx.x * per), b1 = min(n, b0 + per);
  uint32_t mine = 0;
  for (int b = b0; b < b1; ++b) mine += cnt[b];
  uint32_t total;
  uint32_t run = block_exclusive_scan(mine, tmp, &total);
  for (int b = b0; b < b1; ++b) {
    const uint32_t x = cnt[b];
    start[b] = run;
    run += x;
  }
  if (threadIdx.x == 0) start[n] = total;
}

__global__ void __launch_bounds__(spade::kThreads) suffix_init_count_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const uint8_t* __restrict__ emask, const uint8_t* __restrict__ live,
    uint8_t* __restrict__ both, uint32_t* __restrict__ bin_count,
    uint32_t* __restrict__ bin_start, uint32_t* __restrict__ cursor,
    unsigned* __restrict__ ticket, int64_t n_edges, int64_t n_groups, int shift,
    int n_bins) {
  extern __shared__ uint32_t hist[];  // [n_bins]
  __shared__ uint32_t tmp[spade::kWarps + 1];
  __shared__ bool last;
  for (int b = threadIdx.x; b < n_bins; b += spade::kThreads) hist[b] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * spade::kThreads;
  const int64_t tid = (int64_t)blockIdx.x * spade::kThreads + threadIdx.x;
  for (int64_t g = tid; g < n_groups; g += stride) {
    const int64_t base = g * kSlots;
    const uint4 mv = __ldcs(reinterpret_cast<const uint4*>(emask + base));
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
        const uint8_t ls = mj ? __ldg(live + s[j]) : 0;
        const uint8_t ld = mj ? __ldg(live + d[j]) : 0;
        bt[j] = ls && ld;
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (bt[j]) {
          atomicAdd(hist + (s[j] >> shift), 1u);
          atomicAdd(hist + (d[j] >> shift), 1u);
          out[j >> 2] |= 1u << (8 * (j & 3));
        }
      }
    }
    *reinterpret_cast<uint4*>(both + base) = make_uint4(out[0], out[1], out[2], out[3]);
  }
  for (int64_t i = n_groups * kSlots + tid; i < n_edges; i += stride) {
    bool b = false;
    if (emask[i]) {
      const int32_t si = src[i], di = dst[i];
      b = live[si] && live[di];
      if (b) {
        atomicAdd(hist + (si >> shift), 1u);
        atomicAdd(hist + (di >> shift), 1u);
      }
    }
    both[i] = b;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += spade::kThreads)
    if (hist[b]) atomicAdd(bin_count + b, hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < n_bins; b += spade::kThreads) {
    hist[b] = __ldcg(bin_count + b);
    bin_count[b] = 0u;  // ready for the next call
  }
  __syncthreads();
  scan_bins(hist, bin_start, n_bins, tmp);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += spade::kThreads) cursor[b] = bin_start[b];
  if (threadIdx.x == 0) *ticket = 0u;
}

// One slot of a scatter batch: whether it is a both slot, its ends and c.
__device__ __forceinline__ void scatter_slot(const int32_t* src, const int32_t* dst,
                                             const float* c, const uint8_t* both,
                                             int64_t i, int64_t n_edges, bool& b,
                                             int32_t& s, int32_t& d, float& w) {
  b = i < n_edges && both[i];
  s = b ? src[i] : 0;
  d = b ? dst[i] : 0;
  w = b ? c[i] : 0.f;
}

__global__ void __launch_bounds__(spade::kThreads) suffix_init_scatter_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ c, const uint8_t* __restrict__ both,
    uint2* __restrict__ pairs, uint32_t* __restrict__ cursor,
    float* __restrict__ epartials, int64_t n_edges, int vec, int shift, int n_bins) {
  extern __shared__ uint2 stage[];  // [2 * kBatch] pairs, then the bin arrays
  uint32_t* cnt = reinterpret_cast<uint32_t*>(stage + 2 * kBatch);  // [n_bins]
  uint32_t* start = cnt + n_bins;  // [n_bins + 1]
  uint32_t* gbase = start + n_bins + 1;  // [n_bins]
  __shared__ uint32_t tmp[spade::kWarps + 1];
  __shared__ float scratch[spade::kWarps];
  for (int b = threadIdx.x; b < n_bins; b += spade::kThreads) cnt[b] = 0;
  __syncthreads();
  float esum = 0.f;
  const int64_t n_batches = (n_edges + kBatch - 1) / kBatch;
  for (int64_t batch = blockIdx.x; batch < n_batches; batch += gridDim.x) {
    const int64_t base = batch * kBatch + (int64_t)threadIdx.x * kScatterSlots;
    bool b[kScatterSlots];
    int32_t s[kScatterSlots], d[kScatterSlots];
    float w[kScatterSlots];
    if (vec && base + kScatterSlots <= n_edges) {
      const uint4 bv = __ldcs(reinterpret_cast<const uint4*>(both + base));
      const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < kScatterSlots; ++j) b[j] = byte_of(bw, j);
      if (bv.x | bv.y | bv.z | bv.w) {
#pragma unroll
        for (int q = 0; q < kScatterSlots / 4; ++q) {
          const int4 vs = __ldcs(reinterpret_cast<const int4*>(src + base) + q);
          const int4 vd = __ldcs(reinterpret_cast<const int4*>(dst + base) + q);
          const float4 vc = __ldcs(reinterpret_cast<const float4*>(c + base) + q);
          s[4 * q] = vs.x, s[4 * q + 1] = vs.y, s[4 * q + 2] = vs.z, s[4 * q + 3] = vs.w;
          d[4 * q] = vd.x, d[4 * q + 1] = vd.y, d[4 * q + 2] = vd.z, d[4 * q + 3] = vd.w;
          w[4 * q] = vc.x, w[4 * q + 1] = vc.y, w[4 * q + 2] = vc.z, w[4 * q + 3] = vc.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kScatterSlots; ++j)
        scatter_slot(src, dst, c, both, base + j, n_edges, b[j], s[j], d[j], w[j]);
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kScatterSlots; ++j) {
      if (b[j]) {
        any = true;
        esum += w[j];
        atomicAdd(cnt + (s[j] >> shift), 1u);
        atomicAdd(cnt + (d[j] >> shift), 1u);
      }
    }
    if (!__syncthreads_or(any)) continue;  // no both slot in the batch: cnt is still 0
    // each bin's run: its place in the batch and its space in the buffer
    scan_bins(cnt, start, n_bins, tmp);
    __syncthreads();
    for (int k = threadIdx.x; k < n_bins; k += spade::kThreads) {
      const uint32_t n = cnt[k];
      gbase[k] = n ? atomicAdd(cursor + k, n) : 0u;
      cnt[k] = start[k];  // the fill position of the sorted batch
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScatterSlots; ++j) {
      if (b[j]) {
        const uint32_t cw = __float_as_uint(w[j]);
        stage[atomicAdd(cnt + (s[j] >> shift), 1u)] = make_uint2((uint32_t)s[j], cw);
        stage[atomicAdd(cnt + (d[j] >> shift), 1u)] = make_uint2((uint32_t)d[j], cw);
      }
    }
    __syncthreads();
    const uint32_t n_pairs = start[n_bins];
    for (uint32_t i = threadIdx.x; i < n_pairs; i += spade::kThreads) {
      const uint2 pr = stage[i];
      const int k = (int)pr.x >> shift;
      pairs[gbase[k] + (i - start[k])] = pr;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_bins; k += spade::kThreads) cnt[k] = 0;
    __syncthreads();
  }
  esum = spade::block_sum(esum, scratch);
  if (threadIdx.x == 0) epartials[blockIdx.x] = esum;
}

// One CTA a bin: w0[v] = live ? a + (the bin's pairs at v) : 0, the sum in
// float64 and rounded to float32 once; the last block to finish adds the
// vertex and edge sums into f0 in block order.
__global__ void __launch_bounds__(kBinThreads, 2) suffix_init_bins_kernel(
    const uint2* __restrict__ pairs, const uint32_t* __restrict__ bin_start,
    const uint8_t* __restrict__ live, const float* __restrict__ a, float* __restrict__ w0,
    float* __restrict__ vpartials, const float* __restrict__ epartials, int n_eblocks,
    unsigned* __restrict__ ticket, float* __restrict__ f0_out, double* __restrict__ acc_out,
    int64_t n_vertices, int shift) {
  constexpr int NW = kBinThreads / 32;
  extern __shared__ double acc[];  // [2^shift]
  __shared__ float scratch[NW];
  const int64_t lo = (int64_t)blockIdx.x << shift;
  const int nv = (int)min((int64_t)1 << shift, n_vertices - lo);
  for (int i = threadIdx.x; i < nv; i += kBinThreads) acc[i] = 0.0;
  __syncthreads();
  const uint32_t p0 = bin_start[blockIdx.x], p1 = bin_start[blockIdx.x + 1];
  // two pairs a thread in flight before their adds
  uint32_t i = p0 + threadIdx.x;
  for (; i + kBinThreads < p1; i += 2 * kBinThreads) {
    const uint2 x = __ldcs(pairs + i), y = __ldcs(pairs + i + kBinThreads);
    atomicAdd(acc + ((int64_t)x.x - lo), (double)__uint_as_float(x.y));
    atomicAdd(acc + ((int64_t)y.x - lo), (double)__uint_as_float(y.y));
  }
  if (i < p1) {
    const uint2 x = __ldcs(pairs + i);
    atomicAdd(acc + ((int64_t)x.x - lo), (double)__uint_as_float(x.y));
  }
  __syncthreads();
  float sum = 0.f;
  for (int k = threadIdx.x; k < nv; k += kBinThreads) {
    float x = 0.f;
    if (live[lo + k]) {
      const float av = a[lo + k];
      sum += av;
      x = (float)((double)av + acc[k]);
    }
    if (acc_out)
      acc_out[lo + k] = acc[k];
    else
      w0[lo + k] = x;
  }
  if (last_block<NW>(sum, vpartials, ticket, scratch)) {
    const float vsum = ordered_sum<NW>(vpartials, gridDim.x, scratch);
    const float esum = ordered_sum<NW>(epartials, n_eblocks, scratch);
    if (threadIdx.x == 0) {
      if (acc_out) {
        acc_out[n_vertices] = (double)esum;
        *f0_out = vsum;
      } else {
        *f0_out = vsum + esum;
      }
      *ticket = 0u;
    }
  }
}

// Blocks of kThreads for `work` items (vector groups plus scalar slots):
// one wave of the blocks the kernel can keep resident with `smem` bytes of
// dynamic shared memory, at most `cap`.  The resident count is asked once
// per kernel, device and `smem`, so the grid (and the order of the block
// partials) depends only on the call's own sizes.
int grid_for(const void* kernel, int64_t work, int cap, size_t smem = 0) {
  struct Entry { const void* kernel; int dev; size_t smem; int blocks; };
  static Entry known[64];
  static int n_known = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int most = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].dev == dev && known[i].smem == smem)
      most = known[i].blocks;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, spade::kThreads, smem);
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (n_known < 64) known[n_known++] = {kernel, dev, smem, most};
  }
  int64_t want = (work + spade::kThreads - 1) / spade::kThreads;
  if (want > most) want = most;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

// Raises a kernel's dynamic shared memory limit to `bytes` (once per
// kernel and device: the first launch asks).
int allow_smem(const void* kernel, int bytes) {
  struct Entry { const void* kernel; int dev; int bytes; };
  static Entry known[16];
  static int n_known = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].dev == dev && known[i].bytes >= bytes) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (n_known < 16) known[n_known++] = {kernel, dev, bytes};
  return 0;
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

// The warm peel's prologue: the count, scatter and bins kernels.  Bins of
// 2^shift vertices, n_bins = ceil(V / 2^shift) of them (at most
// kMaxBins).  `bin_count` (n_bins uint32s) and `ticket` (2 uint32s) hold
// zeros and are left so; `bin_start` holds n_bins + 1 and `cursor` n_bins
// uint32s; `pairs` room for two pairs (8 B each) a slot; `epartials` room
// for `cap` floats and `vpartials` for n_bins.  Vector groups of 16 slots
// cover [0, 16 * n_groups) in the count pass; `vec` lets the scatter pass
// read whole groups of 16 slots as vectors.  `acc64` null, or V + 1
// doubles: the float64 mode (the bins kernel above).
extern "C" int suffix_init_launch(const void* src, const void* dst, const void* c,
                                  const void* emask, const void* live, const void* a,
                                  void* w0, void* both, void* pairs, void* bin_count,
                                  void* bin_start, void* cursor, void* ticket,
                                  void* epartials, void* vpartials, void* f0, void* acc64,
                                  int64_t n_edges, int64_t n_vertices, int64_t n_groups,
                                  int vec, int shift, int cap, void* stream) {
  auto st = (cudaStream_t)stream;
  const int n_bins = (int)((n_vertices + (1LL << shift) - 1) >> shift);
  if (n_vertices < 1 || n_bins > kMaxBins || shift > kMaxShift) return (int)cudaErrorInvalidValue;
  unsigned* tickets = (unsigned*)ticket;
  const int count_smem = n_bins * 4;
  const int scatter_smem = 2 * kBatch * 8 + (3 * n_bins + 1) * 4;
  const int bins_smem = 8 << shift;
  int err = allow_smem((const void*)suffix_init_count_kernel, count_smem);
  if (!err) err = allow_smem((const void*)suffix_init_scatter_kernel, scatter_smem);
  if (!err) err = allow_smem((const void*)suffix_init_bins_kernel, bins_smem);
  if (err) return err;
  const int nbc = grid_for((const void*)suffix_init_count_kernel,
                           n_groups + (n_edges - n_groups * kSlots), cap, count_smem);
  suffix_init_count_kernel<<<nbc, spade::kThreads, count_smem, st>>>(
      (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)emask, (const uint8_t*)live,
      (uint8_t*)both, (uint32_t*)bin_count, (uint32_t*)bin_start, (uint32_t*)cursor,
      tickets, n_edges, n_groups, shift, n_bins);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int nbs = grid_for((const void*)suffix_init_scatter_kernel,
                           (n_edges + kScatterSlots - 1) / kScatterSlots, cap, scatter_smem);
  suffix_init_scatter_kernel<<<nbs, spade::kThreads, scatter_smem, st>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)c, (const uint8_t*)both,
      (uint2*)pairs, (uint32_t*)cursor, (float*)epartials, n_edges, vec, shift, n_bins);
  err = (int)cudaGetLastError();
  if (err) return err;
  suffix_init_bins_kernel<<<n_bins, kBinThreads, bins_smem, st>>>(
      (const uint2*)pairs, (const uint32_t*)bin_start, (const uint8_t*)live, (const float*)a,
      (float*)w0, (float*)vpartials, (const float*)epartials, nbs, tickets + 1, (float*)f0,
      (double*)acc64, n_vertices, shift);
  return (int)cudaGetLastError();
}
