// K3 flash_attention: causal / sliding-window GQA attention forward, bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, pallas_call at line 116).  Same contract: blocked
// online softmax in f32, scores scaled by 1/sqrt(D) in f32, masked scores
// set to -1e30 (not -inf: exp(m_prev - m_new) of a row whose first visited
// tile is fully masked stays finite, and exp(-1e30 - m) = 0 wipes that
// tile's share once a real key arrives), queries left-aligned (query i at
// position i), kv head = q head / G, output acc / max(l, 1e-30) in bf16.
//
// Bound on the H100: operations.  Per launch it does 4*B*Hq*D*(unmasked
// (q, k) pairs) flops, about 2*B*Hq*D*S^2 when causal: 1.37 TFLOP at B = 2,
// S = 8192, Hq = 40, Hkv = 8, D = 128, i.e. 1.39 ms at 989 TFLOP/s dense
// bf16; it moves q, k, v and o once each (0.40 GB, 0.12 ms at 3.35 TB/s).
//
// Design (a simple first kernel, FlashAttention-2 style, not the TPU grid):
// * one CTA of 4 warps per (q tile of 64 rows, q head, batch); each warp
//   owns 16 query rows.  The TPU's sequential kv grid axis becomes a loop
//   inside the CTA that runs only over the kv tiles the causal / window
//   limits leave live (the tile skip), so no CTA touches a masked tile.
// * q, k and v are read in place with their strides: q in the model layout
//   [B, S, Hkv, G, D] is [B, S, Hq, D] with h = kv*G + g; k and v are never
//   repeated per group.  Rows past the sequence end are zero-filled in
//   shared memory by cp.async and masked (k) or not written (q); no padded
//   copy exists.
// * 64-key K/V tiles are staged in shared memory by cp.async, double
//   buffered (the next tile loads while this one is used), with 16-byte
//   chunks XOR-swizzled by row so ldmatrix reads are free of bank conflicts.
// * Q K^T and P V run on the tensor cores with mma.sync m16n8k16 (bf16
//   operands, f32 accumulation); the scores' accumulator layout is reused as
//   P's operand layout, so P never leaves registers.  Rounding P to bf16 for
//   P V is the one step that departs from the f32 reference.
// * the online-softmax state (m, l, acc) stays in registers.
// wgmma, TMA and warp specialisation are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // query rows per CTA
constexpr int kBN = 64;  // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int64_t q_sb, q_sh, q_ss;  // strides in elements: batch, head, sequence
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int G, Sq, Skv, causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global->shared copy; copies zeros when !pred (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Element offset of (row r, column c) in a [rows][D] bf16 tile whose
// 16-byte chunks are XOR-swizzled by (r % 8); c is a multiple of 8.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ (r & 7))) << 3);
}

// Stage rows [row0, row0 + 64) of one head into a swizzled tile; rows at or
// past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int64_t row_stride, int row0, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(tile + swz<D>(r, c), base + (int64_t)(ok ? row : 0) * row_stride + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * D;      // [2][kBN * D]
  __nv_bfloat16* sV = sK + 2 * kBN * D;  // [2][kBN * D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment row group / column pair
  // heaviest causal tiles first: they launch in the first wave
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  // live kv tiles [t_lo, t_hi): keys < Skv, <= the tile's last query when
  // causal, > its first query - window when windowed
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q0 + kBM);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / kBN;
  const int t_hi = k_hi > k_lo ? (k_hi + kBN - 1) / kBN : t_lo;

  load_tile<D>(sQ, qb, p.q_ss, q0, p.Sq);
  if (t_lo < t_hi) {
    load_tile<D>(sK, kb, p.k_ss, t_lo * kBN, p.Skv);
    load_tile<D>(sV, vb, p.v_ss, t_lo * kBN, p.Skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, one per 16-wide d step
  uint32_t qf[D / 16][4];
  {
    const int mi = lane >> 3;
    const int r = warp * 16 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], sQ + swz<D>(r, kk * 16 + (mi >> 1) * 8));
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // rows grp and grp + 8 of the warp's 16
  float l_run[2] = {0.f, 0.f};    // this thread's share of l (summed at the end)
  const int row_a = q0 + warp * 16 + grp;  // query position of c[0], c[1]

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_tile<D>(sK + (buf ^ 1) * kBN * D, kb, p.k_ss, (t + 1) * kBN, p.Skv);
      load_tile<D>(sV + (buf ^ 1) * kBN * D, vb, p.v_ss, (t + 1) * kBN, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kBN * D;
    const __nv_bfloat16* tV = sV + buf * kBN * D;
    const int k0 = t * kBN;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nn = 0; nn < kBN / 16; ++nn) {
          uint32_t bk[4];
          ldsm_x4(bk, tK + swz<D>(nn * 16 + (lane & 7) + (mi >> 1) * 8, kk * 16 + (mi & 1) * 8));
          mma_bf16(s[2 * nn], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
        }
      }
    }

    // scale in f32, then mask where the tile straddles a limit
    const bool need_mask = (k0 + kBN > p.Skv) || (p.causal && k0 + kBN - 1 > q0) ||
                           (p.window > 0 && k0 <= q0 + kBM - 1 - p.window);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (need_mask) {
          const int qp = row_a + (e >> 1) * 8;
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          bool ok = kp < p.Skv;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          x = ok ? x : kNeg;
        }
        s[j][e] = x;
      }
    }

    // online softmax, rows grp (r = 0) and grp + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = __expf(m_run[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float p0 = __expf(s[j][2 * r] - mx);
        const float p1 = __expf(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = mx;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // acc += P V; P's A fragments come straight from the score registers
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int kj = 0; kj < kBN / 16; ++kj) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kj][0], s[2 * kj][1]);
        pa[1] = pack_bf16(s[2 * kj][2], s[2 * kj][3]);
        pa[2] = pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]);
        pa[3] = pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, tV + swz<D>(kj * 16 + (lane & 7) + (mi & 1) * 8, dn * 16 + (mi >> 1) * 8));
          mma_bf16(acc[2 * dn], pa, bv[0], bv[1]);
          mma_bf16(acc[2 * dn + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // epilogue: l summed over the quad, out = acc / max(l, 1e-30)
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
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      }
    }
  }
}

template <int D>
int launch(const Params& p, int B, int Hq, cudaStream_t stream) {
  constexpr int kSmem = (kBM + 4 * kBN) * D * (int)sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.Sq + kBM - 1) / kBM, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D], o: [B, Hq, Sq, D], all bf16 with
// a unit last stride; strides in elements.  Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int causal, int window, float scale, void* stream) {
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.k = (const __nv_bfloat16*)k;
  p.v = (const __nv_bfloat16*)v;
  p.o = (__nv_bfloat16*)o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.G = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  if (D == 128) return launch<128>(p, B, Hq, (cudaStream_t)stream);
  if (D == 64) return launch<64>(p, B, Hq, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
