// K3 flash_attention: causal / sliding-window GQA attention forward for
// Hopper (sm_90a), two bodies.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, pallas_call at line 116).  Same contract: blocked
// online softmax in f32, scores scaled by 1/sqrt(D), masked scores at -1e30,
// queries left-aligned (query i at position i), kv head = q head / G, output
// acc / max(l, 1e-30) in the inputs' dtype.  One extension: `q_off` puts
// query i at position i + q_off (0 is the Pallas kernel's contract), so a
// rank that holds one shard of a sequence-sharded q attends over the whole
// k and v with the causal and window masks of its rows' true positions.
// The Pallas kernel takes any float dtype and head dim (it casts its tiles
// to f32); so does K3: the tensor-core body below takes bf16 at D 64 and
// 128 (the models' serving widths), and the SIMT body at the end of the
// file takes float32, float16 and bf16 at any D up to 256 (the smoke
// configs' float32 at D 16 among them).
//
// Bound on the H100: operations.  A launch does 4*B*Hq*D*(unmasked (q, k)
// pairs) flops, about 2*B*Hq*D*S^2 when causal: 1.375 TFLOP at B = 2,
// S = 8192, Hq = 40, Hkv = 8, D = 128, 1.39 ms at 989 TFLOP/s dense bf16;
// it moves q, k, v and o once each (0.40 GB, 0.12 ms at 3.35 TB/s).  Only
// wgmma reaches the tensor cores' full rate, so the design is built around
// keeping two warpgroups issuing it:
//
// * A CTA of three warpgroups (384 threads) takes 128 query rows of one
//   (q head, batch) and walks kv tiles of 128 keys.  The TPU's sequential kv
//   grid axis becomes that loop; it visits only the tiles the causal /
//   window / length limits leave live for the CTA's rows (the reference's
//   `live` rule: no fully masked tile is read), in ascending order.  Grid
//   (Hq, B, q tiles) with the q tile reversed: every head's heaviest causal
//   tile is in the first wave.
// * Warpgroup 0 is the producer.  It drops to 24 registers (setmaxnreg) and
//   one thread issues TMA loads: Q once, then K and V of each live tile into
//   a ring of two stages, each with full and empty mbarriers for K and
//   for V.  The loads read q, k and v in place through 4-D tensor maps over
//   (D, S, H, B) with the tensors' own strides (the model layout's permuted
//   views included), 128-byte swizzled boxes of 64 columns x 128 rows: TMA
//   zero-fills rows past S inside one head and never reads another head's
//   rows, so no padded copy and no GQA repeat exists.
// * Warpgroups 1 and 2 are consumers, 64 query rows each, at 240 registers.
//   S = Q K^T is D/16 wgmma m64n128k16 with both operands in shared memory
//   (K-major descriptors); the consumer releases K as soon as it completes.
//   The online softmax runs on the accumulator registers: scale and log2(e)
//   folded into one FFMA per score and ex2; the row max takes two quad
//   shuffles and the row sum is kept per thread until the epilogue; masks
//   are applied only on tiles that straddle a limit.  O += P V is 8 wgmma
//   m64nDk16 with P from registers (the scores' accumulator layout is
//   wgmma's A fragment layout, so P never touches shared memory) and V from
//   shared memory as an MN-major operand; then V is released.  Rounding P
//   to bf16 is the one step that departs from the f32 reference.
// * Within a consumer, tile j's Q K^T is issued together with tile j-1's
//   P V, and tile j's softmax runs on the CUDA cores while that P V is still
//   on the tensor cores; O is rescaled once the P V has completed.  Between
//   the consumers, two named barriers hand the turn to issue products back
//   and forth (ping-pong), so one warpgroup's softmax runs while the other's
//   products keep the tensor cores busy.
// * The masked score is -2^100 rather than -1e30, so that the one-FFMA
//   exponent (s - m) * c = fma(s, c, -m*c) stays exact when s = m = -2^100
//   (a power of two times c is exact).  Both values act alike: exp of them
//   minus a live row's max is 0, and in a row whose visited keys are all
//   masked so far each gets p = 1, which the reference's correction
//   exp(-huge - m) = 0 wipes when the row's first live key arrives.
// * The epilogue divides by max(l, 1e-30) and writes bf16 rows < Sq straight
//   from registers with out's strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;  // query rows per CTA (64 per consumer warpgroup)
constexpr int kBN = 128;  // keys per kv tile
constexpr int kBoxCols = 64;  // columns per TMA box: 128 bytes, the swizzle span
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr float kNeg = -0x1p100f;  // the masked score (see the note above)
constexpr int kEncodeError = 10000;  // + CUresult of a failed tensor-map encode

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one K or one V tile
  static constexpr int kBars = 1 + 4 * kStages;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1 KB
  // period, then Q, the K ring, the V ring and the barriers
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_sh, o_ss;  // out's strides in elements: batch, head, sequence
  int G, Sq, Skv, causal, window;  // window <= 0: none
  int q_off;  // position of query row 0 (a sequence shard's offset)
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// --- TMA ---------------------------------------------------------------------

// One box of the 4-D map at (column c0, row c1, head c2, batch c3) into
// shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers 1 and 2 pass the tensor cores between the two consumer
// warpgroups (256 threads: one warpgroup syncs, the other arrives).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of accumulator registers across a
// wgmma (which would serialise the asynchronous products).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16 bf16 from registers, wgmma's A fragment) * B (16 x N,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db, 1);
  } else {
    wgmma_rs_n64(o, a, db, 1);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;             // [kStages][kBoxes][kBN][64]
  const uint32_t sV = sK + kStages * C::kKVBytes;  // [kStages][kBoxes][kBN][64]
  const uint32_t bars = sV + kStages * C::kKVBytes;  // 8-byte mbarriers
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest causal tiles first
  const int kvh = h / p.G;

  // live kv tiles [t_lo, t_hi) for the CTA's rows: keys < Skv, <= its last
  // query's position when causal, > its first query's position - window
  // when windowed (row i sits at position i + q_off)
  const int pos0 = q0 + p.q_off;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, pos0 + kBM);
  const int k_lo = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  const int t_lo = k_lo / kBN;
  const int t_hi = k_hi > k_lo ? (k_hi + kBN - 1) / kBN : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(sQ + x * kBM * 128, &tq, full_q, x * kBoxCols, q0, h, b);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect_tx(full_k(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sK + s * C::kKVBytes + x * kBN * 128, &tk, full_k(s), x * kBoxCols,
                   t * kBN, kvh, b);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sV + s * C::kKVBytes + x * kBN * 128, &tv, full_v(s), x * kBoxCols,
                   t * kBN, kvh, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int lq = lane >> 2, lk = (lane & 3) * 2;  // accumulator row / column pair
    const int wr0 = q0 + wg * 64;                   // the warpgroup's first query
    const int row_a = wr0 + warp * 16 + lq;         // this thread's rows: row_a, row_a + 8
    const int wp0 = wr0 + p.q_off;                  // their positions: + q_off
    const float c = p.scale_log2;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNeg, kNeg};
    float l_run[2] = {0.f, 0.f};  // this thread's share of l (summed at the end)

    // S = Q K^T of the tile in stage s into sc (issued and committed, not
    // waited for)
    auto issue_qk = [&](float (&sc)[kBN / 2], int s, uint32_t ph) {
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k step kk: box kk / 4, 32 bytes into its 128-byte swizzled rows
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = sw128_desc(sQ + (kk / 4) * kBM * 128 + wg * 64 * 128 + col, 16, 1024);
        const uint64_t db = sw128_desc(sK + s * C::kKVBytes + (kk / 4) * kBN * 128 + col, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s (issued and committed)
    auto issue_pv = [&](const uint32_t (&pa)[kBN / 16][4], int s, uint32_t ph) {
      mbar_wait(full_v(s), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = sw128_desc(sV + s * C::kKVBytes + kk * 16 * 128, kBN * 128, 1024);
        wgmma_pv<D>(o, pa[kk], db);
      }
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // masks and the online softmax of the scores of keys k0.. : sc becomes
    // P, m and l move on, corr is the factor O must take
    auto softmax = [&](float (&sc)[kBN / 2], int k0, float (&corr)[2]) {
      // masks, only where the tile straddles a limit of this warpgroup's rows
      const bool need_mask = (k0 + kBN > p.Skv) || (p.causal && k0 + kBN - 1 > wp0) ||
                             (p.window > 0 && k0 <= wp0 + 63 - p.window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row_a + p.q_off + (e >> 1) * 8;
            const int kp = k0 + j * 8 + lk + (e & 1);
            bool ok = kp < p.Skv;
            if (p.causal) ok = ok && kp <= qp;
            if (p.window > 0) ok = ok && kp > qp - p.window;
            if (!ok) sc[4 * j + e] = kNeg;
          }
        }
      }
      // rows row_a (r = 0) and row_a + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = ex2((m_run[r] - mx) * c);
        const float mc = mx * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float p0 = ex2(fmaf(sc[4 * j + 2 * r], c, -mc));
          const float p1 = ex2(fmaf(sc[4 * j + 2 * r + 1], c, -mc));
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_run[r] = l_run[r] * corr[r] + sum;
        m_run[r] = mx;
      }
    };
    auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    };
    // P in bf16 as wgmma A fragments, one per 16 keys
    auto pack = [&](const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // ping-pong: a warpgroup issues its products only in its turn, so one
    // warpgroup's softmax runs while the other's products fill the tensor
    // cores; consumer 0 goes first
    auto my_turn = [&] { bar_sync(1 + wg); };
    auto your_turn = [&] { bar_arrive(2 - wg); };
    if (wg == 1) bar_arrive(1);
    mbar_wait(full_q, 0);
    if (t_lo < t_hi) {
      // tile t_lo: scores, softmax, P; its P V is issued in the next step
      float sc[kBN / 2], corr[2];
      uint32_t pa[kBN / 16][4];
      my_turn();
      issue_qk(sc, 0, 0);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k(0));
      softmax(sc, t_lo * kBN, corr);
      pack(sc, pa);
      // each later tile's Q K^T runs beside the previous tile's P V on the
      // tensor cores, and its softmax waits only for its own scores
      for (int t = t_lo + 1, i = 1; t < t_hi; ++t, ++i) {
        const int s = i % kStages, sp = (i - 1) % kStages;
        my_turn();
        issue_qk(sc, s, (i / kStages) & 1);
        issue_pv(pa, sp, ((i - 1) / kStages) & 1);
        your_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        release(empty_k(s));
        softmax(sc, t * kBN, corr);
        wgmma_wait<0>();
        fence_regs(o);
        release(empty_v(sp));
        rescale(corr);
        pack(sc, pa);
      }
      const int n = t_hi - t_lo, sl = (n - 1) % kStages;
      my_turn();
      issue_pv(pa, sl, ((n - 1) / kStages) & 1);
      your_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v(sl));
    }
    if (wg == 0) bar_sync(1);  // the other warpgroup's last hand-over
    // epilogue: l summed over the quad, out = o / max(l, 1e-30)
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float den = fmaxf(l, 1e-30f);
      const int row = row_a + r * 8;
      if (row < p.Sq) {
        __nv_bfloat16* orow = ob + (int64_t)row * p.o_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + lk) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// f: dims (D, S, H, B), byte strides of S, H and B, box (columns, rows).
int encode(CUtensorMap* map, const void* data, const uint64_t* f, int rows) {
  if (f[7] != (uint64_t)kBoxCols || f[8] != (uint64_t)rows) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {f[0], f[1], f[2], f[3]};
  const cuuint64_t strides[3] = {f[4], f[5], f[6]};
  const cuuint32_t box[4] = {(cuuint32_t)f[7], (cuuint32_t)f[8], 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, int Hq, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<D>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(Hq, B, (p.Sq + kBM - 1) / kBM);
  flash_fwd_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The SIMT body: float32, float16 or bf16 data at any head dim up to 256,
// every product in f32 FFMA on the CUDA cores, as the Pallas kernel's f32
// tiles are (so f32 data keeps f32 precision; the tensor cores would round
// it to tf32 or bf16).  Bound on the H100: operations, 4*B*Hq*D*(unmasked
// pairs) flops at 67 TFLOP/s.
//
// It is built as a register-blocked SGEMM, which is how the FP32 pipes are
// fed without tensor cores.  A CTA of 256 threads takes 64 query rows of
// one (q head, batch) and walks the keys its rows can see in tiles of 64,
// the tile loop of the Pallas grid's kv axis.  Q, each K tile and each V
// tile sit in shared memory as f32, zero-padded to DP = 64, 128 or 256
// columns (D rounded up); Q and K rows are stored with their 16-byte chunks
// XOR-swizzled by the row, so every read below is free of bank conflicts.
// Thread (row group rg, lane group cg) owns rows 4rg..4rg+3: of S the keys
// cg + 16j (j < 4), of O the columns 64c + 4cg..+3 (c < DP/64).  S = Q K^T
// is built from float4 outer products (4 Q and 4 K chunks feed 64 FFMAs; the
// warp's 16 lanes of a row read one Q chunk, a broadcast), then masked,
// scaled and run through the reference's per-tile online softmax: the tile
// max over the row's 16 lanes by xor shuffles, one correction
// exp(m - m_new), masked scores at -1e30 (a row whose keys are all masked
// so far gets p = 1, which the correction wipes when its first live key
// arrives, as in the reference), keys past Skv taking no part.  P goes to
// shared memory (swizzled) and O += P V takes float4 outer products of P
// and V again.  Each row's l is summed per lane and over its 16 lanes once,
// at the end, in a fixed order: no atomics, the same bits every launch.
//
// Loading: one K and one V buffer, refilled as soon as they are consumed,
// so tile j+1's K streams in during tile j's softmax and P V, and its V
// during tile j+1's Q K^T.  float32 data with 16-byte aligned rows goes by
// cp.async (16 bytes, zero-filled past the ends); float16, bf16 and other
// float32 data by loads converted to f32 in registers.  Grid (q tiles x
// Hq, B), the head fastest and the q tiles reversed, so every head's
// heaviest causal tiles start first.
// Shared memory: (3 * 64 * DP + 64 * 64) * 4 bytes, 112 KB at DP 128 (two
// CTAs, 16 warps an SM), 208 KB at DP 256.
constexpr int kSimtRows = 64;      // query rows per CTA
constexpr int kSimtKeys = 64;      // keys per kv tile
constexpr int kSimtThreads = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr float kSimtNeg = -1e30f;

template <int DP>
struct SimtCfg {
  static constexpr int kTile = kSimtRows * DP;  // floats of Q, of a K and of a V tile
  static constexpr int kP = kSimtRows * kSimtKeys;
  static constexpr int kSmem = (3 * kTile + kP) * 4;
  static constexpr int kCols = DP / 64;  // float4 column chunks of O a thread owns
  static constexpr int kMinBlocks = DP >= 256 ? 1 : 2;
};

struct SimtParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int G, Hkv, Sq, Skv, D, causal, window, async_copy;
  int q_off;  // position of query row 0 (a sequence shard's offset)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Float offset of 16-byte chunk `ch` of row `r` in a tile of W floats a row,
// the chunks swizzled by the row (W / 4 >= 8).
template <int W>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * W + ((ch ^ (r & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem, bool full) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + 64) of a [S, D] slab with sequence stride ss into a
// [64][DP] f32 tile (swizzled or not), zero past r_end and past D: by
// cp.async when `async_copy` (float32 with 16-byte aligned rows), else by
// converting loads.
template <typename T, int DP, bool kSwizzle>
__device__ __forceinline__ void load_tile(float* tile, const T* g, int64_t ss, int r0,
                                          int r_end, int D, bool async_copy) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < kSimtRows * kChunks; i += kSimtThreads) {
    const int r = i / kChunks, ch = i % kChunks, d = 4 * ch;
    float* out = tile + (kSwizzle ? swz<DP>(r, ch) : r * DP + d);
    const bool in = r0 + r < r_end;
    const T* row = g + (int64_t)(r0 + r) * ss;
    if (std::is_same<T, float>::value && async_copy) {
      const bool full = in && d < D;
      cp_async16(out, full ? (const void*)(row + d) : (const void*)g, full);
      continue;
    }
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) {
      if (d < D) x.x = to_f32(row[d]);
      if (d + 1 < D) x.y = to_f32(row[d + 1]);
      if (d + 2 < D) x.z = to_f32(row[d + 2]);
      if (d + 3 < D) x.w = to_f32(row[d + 3]);
    }
    *reinterpret_cast<float4*>(out) = x;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kSimtThreads, SimtCfg<DP>::kMinBlocks)
    flash_simt_kernel(const SimtParams p) {
  using C = SimtCfg<DP>;
  constexpr int NC = C::kCols;
  extern __shared__ float4 simt_sm[];
  float* qs = reinterpret_cast<float*>(simt_sm);  // [64][DP] swizzled
  float* ks = qs + C::kTile;                      // [64][DP] swizzled
  float* vs = ks + C::kTile;                      // [64][DP]
  float* ps = vs + C::kTile;                      // [64][64] swizzled
  // blockIdx.x runs over (q tile, head) with the head fastest and the q
  // tiles from the last: every head's heaviest causal tiles start first
  const int n_heads = p.G * p.Hkv;
  const int h = blockIdx.x % n_heads, b = blockIdx.y;
  const int n_qt = (p.Sq + kSimtRows - 1) / kSimtRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_heads)) * kSimtRows;
  const int lane = threadIdx.x & 31;
  const int rg = 2 * (threadIdx.x >> 5) + (lane >> 4);  // rows 4rg .. 4rg + 3
  const int cg = lane & 15;
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + (h / p.G) * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + (h / p.G) * p.v_sh;
  const bool async_copy = p.async_copy;
  // the keys any row of the tile can see (row i sits at position i + q_off)
  int k_end = p.Skv;
  if (p.causal) k_end = min(k_end, min(q0 + kSimtRows, p.Sq) + p.q_off);
  const int k_begin = p.window > 0 ? max(0, q0 + p.q_off - p.window + 1) : 0;

  // groups in order: Q, K_0, V_0, then K_{j+1} and V_{j+1} in tile j
  load_tile<T, DP, true>(qs, q, p.q_ss, q0, p.Sq, p.D, async_copy);
  cp_async_commit();
  if (k_begin < k_end) load_tile<T, DP, true>(ks, k, p.k_ss, k_begin, k_end, p.D, async_copy);
  cp_async_commit();
  if (k_begin < k_end) load_tile<T, DP, false>(vs, v, p.v_ss, k_begin, k_end, p.D, async_copy);
  cp_async_commit();

  float o[4][4 * NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kSimtNeg, l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kSimtKeys) {
    cp_async_wait<1>();  // Q and K_j have landed (V_j may be in flight)
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int ch = 0; ch < DP / 4; ++ch) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + swz<DP>(4 * rg + i, ch));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + swz<DP>(cg + 16 * j, ch));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }
    __syncthreads();  // K_j is consumed: refill its buffer with K_{j+1}
    const int k_next = k0 + kSimtKeys;
    if (k_next < k_end)
      load_tile<T, DP, true>(ks, k, p.k_ss, k_next, k_end, p.D, async_copy);
    cp_async_commit();

    const int nk = min(kSimtKeys, k_end - k0);  // keys of the tile inside [k_begin, k_end)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i + p.q_off;
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 16 * j;
        bool ok = true;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && key > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kSimtNeg;
        if (cg + 16 * j < nk) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int x = 8; x > 0; x >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float corr = expf(m[i] - mt);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = cg + 16 * j;
        const float e = kk < nk ? expf(s[i][j] - mt) : 0.f;
        ls += e;
        ps[swz<kSimtKeys>(4 * rg + i, kk >> 2) + (kk & 3)] = e;
      }
      l[i] = l[i] * corr + ls;
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= corr;
    }
    cp_async_wait<1>();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();     // and P is written
    const int n_chunks = (nk + 3) >> 2;
#pragma unroll 2
    for (int kc = 0; kc < n_chunks; ++kc) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + swz<kSimtKeys>(4 * rg + i, kc));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (4 * kc + e) * DP + 4 * cg;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vf = *reinterpret_cast<const float4*>(vrow + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = lane_of(pf[i], e);
            o[i][4 * c] = fmaf(pv, vf.x, o[i][4 * c]);
            o[i][4 * c + 1] = fmaf(pv, vf.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(pv, vf.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(pv, vf.w, o[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // V_j and P are consumed: refill V with V_{j+1}
    if (k_next < k_end)
      load_tile<T, DP, false>(vs, v, p.v_ss, k_next, k_end, p.D, async_copy);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int x = 8; x > 0; x >>= 1) li += __shfl_xor_sync(0xffffffffu, li, x);
    const int row = q0 + 4 * rg + i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(li, 1e-30f);
    T* out = (T*)p.o + b * p.o_sb + h * p.o_sh + (int64_t)row * p.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * cg + e;
        if (col < p.D) out[col] = from_f32<T>(o[i][4 * c + e] / den);
      }
  }
}

template <typename T, int DP>
int launch_simt(const SimtParams& p, int B, int Hq, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_simt_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SimtCfg<DP>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int64_t n_qt = (p.Sq + kSimtRows - 1) / kSimtRows;
  if (n_qt * Hq > INT32_MAX || B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)(n_qt * Hq), B);
  flash_simt_kernel<T, DP><<<grid, kSimtThreads, SimtCfg<DP>::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt_d(const SimtParams& p, int B, int Hq, cudaStream_t stream) {
  if (p.D <= 64) return launch_simt<T, 64>(p, B, Hq, stream);
  if (p.D <= 128) return launch_simt<T, 128>(p, B, Hq, stream);
  return launch_simt<T, 256>(p, B, Hq, stream);
}

}  // namespace

// Dynamic shared memory of one CTA at head dim D (0 for another D).
extern "C" int flash_attention_smem_bytes(int D) {
  return D == 128 ? Cfg<128>::kSmem : D == 64 ? Cfg<64>::kSmem : 0;
}

// q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D], o: [B, Hq, Sq, D], bf16 with a
// unit last stride; query i at position i + q_off (q_off >= 0).  `maps`
// holds 9 values for each of q, k and v: dims (D, S, H, B), byte strides
// of S, H and B, and the box (64, 128).  out's strides are in elements.
// Returns a cudaError_t (0 = ok), or kEncodeError + the CUresult of a
// tensor map that would not encode.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const uint64_t* maps, int B, int Hq, int Hkv, int Sq,
                                      int Skv, int D, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                      int causal, int window, int q_off, float scale_log2,
                                      void* stream) {
  if ((D != 64 && D != 128) || q_off < 0) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, maps, kBM);
  if (!err) err = encode(&tk, k, maps + 9, kBN);
  if (!err) err = encode(&tv, v, maps + 18, kBN);
  if (err) return err;
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.G = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale_log2 = scale_log2;
  if (D == 128) return launch<128>(tq, tk, tv, p, B, Hq, (cudaStream_t)stream);
  return launch<64>(tq, tk, tv, p, B, Hq, (cudaStream_t)stream);
}

// The SIMT body.  q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D], o: [B, Hq, Sq, D]
// with a unit last stride; `strides` holds the batch, head and sequence
// strides in elements of q, k, v and o (12 values).  dtype: 0 float32,
// 1 bf16, 2 float16.  1 <= D <= 256; query i at position i + q_off.
// Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_simt_launch(const void* q, const void* k, const void* v,
                                           void* o, const int64_t* strides, int B, int Hq,
                                           int Hkv, int Sq, int Skv, int D, int dtype,
                                           int causal, int window, int q_off, float scale,
                                           void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv || q_off < 0) return (int)cudaErrorInvalidValue;
  SimtParams p;
  p.q = q, p.k = k, p.v = v, p.o = o;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.G = Hq / Hkv, p.Hkv = Hkv, p.Sq = Sq, p.Skv = Skv, p.D = D;
  p.causal = causal, p.window = window, p.q_off = q_off, p.scale = scale;
  // cp.async takes float32 rows whose every 16-byte chunk is aligned
  bool aligned = dtype == 0 && D % 4 == 0;
  aligned = aligned && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
            (uintptr_t)v % 16 == 0;
  for (int i = 0; i < 9; ++i) aligned = aligned && strides[i] % 4 == 0;
  p.async_copy = aligned;
  auto st = (cudaStream_t)stream;
  if (dtype == 0) return launch_simt_d<float>(p, B, Hq, st);
  if (dtype == 1) return launch_simt_d<__nv_bfloat16>(p, B, Hq, st);
  if (dtype == 2) return launch_simt_d<__half>(p, B, Hq, st);
  return (int)cudaErrorInvalidValue;
}
