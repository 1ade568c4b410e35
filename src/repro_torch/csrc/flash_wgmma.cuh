// bf16 flash-attention core for Hopper: both products on the tensor cores
// (wgmma), K/V tiles through a TMA ring.  Shared by the dense flash kernel
// (flash_attn.cu) and the paged-prefill kernel (paged_prefill_attn.cu);
// their float32 path keeps the SIMT core of flash_core.cuh.
//
// Computes causal or windowed softmax(scale * Q K^T) V with Dk != Dv, a
// query offset and GQA, as src/repro/kernels/flash_attn.py:79 does; with
// paged keys, the N prior pool pages named by the block table (all
// visible) then the dense suffix (causal) in one running softmax, as
// src/repro/kernels/paged_prefill_attn.py:80 does.
//
// What bounds it on the H100: operations.  A 2048-token causal MLA chunk
// (64 heads, Dk 192, Dv 128) is 8.6e10 FLOP over ~120 MB, ~700 FLOP/byte,
// above the card's ~295 ridge; only the bf16 tensor cores (989 TFLOP/s,
// 15x the float32 SIMT rate) can approach the bound.
//
// Design:
// * A block of 384 threads owns 128 query rows of one (batch, query head):
//   two consumer warpgroups of 64 rows and a producer warpgroup whose
//   first warp issues every load.  setmaxnreg moves registers from the
//   producer (40 a thread) to the consumers (232), which hold the output
//   accumulator, the S tile and P.  The block walks only the key tiles
//   some row can see (causal end, window start); a warpgroup whose rows
//   see none of a tile skips its products.  Heavier (later) causal query
//   tiles are scheduled first.
// * The producer loads the Q tile once and each K/V tile into a ring of
//   2-4 stages (as many as fit in 227 KB) with cp.async.bulk.tensor on
//   full/empty mbarriers.  Every tile is a set of 64-column panels of
//   128-byte rows with the 128-byte swizzle, the layout wgmma reads
//   without bank conflicts.  Q, K and V maps are 3-D over (batch * head,
//   row, column), so rows past the end and columns past Dk or Dv are
//   zero-filled by TMA instead of read from the next head.
// * Keys a tile (tile_keys): 128 at Dk, Dv <= 128 (three stages: Q 32 KB,
//   a stage 64 KB), 64 above (Dk 192 / Dv 128: Q 48 KB and four stages of
//   40 KB).
// * S = Q K^T is wgmma m64nBKk16 from shared memory (both operands
//   K-major), float32 accumulators; scale is applied to S in float32 and
//   folded with log2(e) into one multiply before exp2f.  The mask runs only
//   on tiles that cross the causal or window boundary or the end of S.
// * P V takes P from registers (the S accumulator layout is the A
//   fragment layout) and V from shared memory as an MN-major B operand,
//   one m64n64k16 per 64 output columns.  P is split into bf16 hi + lo
//   parts, two products into one accumulator: a bf16 P alone rounds each
//   weight by up to 2^-9, and at the MLA prefill shape that alone needs an
//   atol of 2.4e-3 against the float32 plain version, above the 2e-3 the
//   checks allow; hi + lo keeps ~16 bits.  It costs one more P V product
//   a tile (Dv / (Dk + Dv) more tensor work).
// * QK^T, softmax and P V run one after another in each warpgroup; the two
//   warpgroups wait on the same tiles and so mostly run in step, which is
//   what holds the tensor cores to about a third of their peak.
// * A row that saw no key writes 0, as the TPU kernel does.
#pragma once
#include <cuda.h>

#include <initializer_list>

#include "common.cuh"

namespace flash_wgmma {

constexpr int BQ = 128;                  // query rows per block
constexpr int NT = 384;                  // 2 consumer warpgroups + producer
constexpr int PRODUCER_REGS = 40;        // setmaxnreg: 40 * 128 + 232 * 256
constexpr int CONSUMER_REGS = 232;       //   = 168 * 384 registers a block
constexpr int MAX_STAGES = 4;
constexpr int Q_PANEL = BQ * 128;        // bytes of a 64-column Q panel
constexpr int SMEM_MAX = 232448;         // a block's shared memory (H100)
constexpr int SMEM_FIXED = 1024 + 16 * MAX_STAGES + 8;  // align + barriers

// Keys a tile: 128 (QK^T as m64n128k16) where the 64 x 128 S tile, its
// bf16 hi + lo P and the 64 x Dv output fit the consumers' 232 registers
// (Dv <= 128) and three stages fit beside Q (Dk <= 128); 64 otherwise.
// At Dk 192 a 128-key tile fits only two stages and ran slower than four
// of 64 keys on the H100.
__host__ __device__ constexpr int tile_keys(int KP, int NVP) {
  return (NVP <= 2 && KP <= 2) ? 128 : 64;
}

struct Params {
  CUtensorMap tq;        // Q (B * Hq, Sq, Dk)
  CUtensorMap tk, tv;    // dense K / V (B * Hkv, Sk, D), or the page pools
                         // (Hkv, P * T, D)
  CUtensorMap tks, tvs;  // paged: the suffix (B * Hkv, Ssuf, D)
  __nv_bfloat16* o;      // (B, Hq, Sq, Dv)
  const int* tables;     // paged: (B, N)
  int Hq, Hkv, Sq, Sk, Dv, KP, stages, q_offset, causal, window;
  int N, T, prior;       // paged: table width, page tokens, N * T
  float scale_log2;      // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); `lbo` is the byte stride
// between 64-element chunks along M/N of an MN-major operand (unused for
// K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PRFAAS_D8(o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define PRFAAS_D32 PRFAAS_D8(0), PRFAAS_D8(8), PRFAAS_D8(16), PRFAAS_D8(24)
#define PRFAAS_D64                                                          \
  PRFAAS_D32, PRFAAS_D8(32), PRFAAS_D8(40), PRFAAS_D8(48), PRFAAS_D8(56)
#define PRFAAS_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define PRFAAS_R64                                                          \
  PRFAAS_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, float32) = or += A (smem, K-major) * B (smem, K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PRFAAS_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PRFAAS_D32
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PRFAAS_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PRFAAS_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A (registers, bf16 pairs) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PRFAAS_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PRFAAS_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PRFAAS_D8
#undef PRFAAS_D32
#undef PRFAAS_D64
#undef PRFAAS_R32
#undef PRFAAS_R64

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Issues tile t's K and V loads into one ring stage.  Dense keys: one box
// of BK rows per 64-column panel.  Paged keys: BK / T boxes of T rows,
// lane j issuing box j: key kk < prior lives in pool page tables[b, kk /
// T] of head hk, key kk >= prior is suffix row kk - prior; `page` is the
// lane's page id, read a tile ahead.
template <int NVP, int BK, bool kPaged>
__device__ __forceinline__ void issue_tile(const Params& p, int t, int b,
                                           int hk, int lane, int page,
                                           uint32_t sK, uint32_t sV,
                                           uint32_t bar) {
  constexpr int PANEL = BK * 128;
  if constexpr (!kPaged) {
    if (lane == 0) {
      const int z = b * p.Hkv + hk;
      for (int c = 0; c < p.KP; ++c)
        tma_load(sK + c * PANEL, &p.tk, bar, c * 64, t * BK, z);
#pragma unroll
      for (int c = 0; c < NVP; ++c)
        tma_load(sV + c * PANEL, &p.tv, bar, c * 64, t * BK, z);
    }
  } else {
    if (lane < BK / p.T) {
      const int kk = t * BK + lane * p.T;
      const uint32_t off = lane * p.T * 128;
      const bool prior = kk < p.prior;
      const CUtensorMap* mk = prior ? &p.tk : &p.tks;
      const CUtensorMap* mv = prior ? &p.tv : &p.tvs;
      const int r = prior ? page * p.T : kk - p.prior;
      const int z = prior ? hk : b * p.Hkv + hk;
      for (int c = 0; c < p.KP; ++c)
        tma_load(sK + c * PANEL + off, mk, bar, c * 64, r, z);
#pragma unroll
      for (int c = 0; c < NVP; ++c)
        tma_load(sV + c * PANEL + off, mv, bar, c * 64, r, z);
    }
  }
}

template <int BK, bool kPaged>
__device__ __forceinline__ int page_of(const Params& p, int t, int b,
                                       int lane, int t_end) {
  if constexpr (kPaged) {
    const int kk = t * BK + lane * p.T;
    if (t < t_end && lane < BK / p.T && kk < p.prior)
      return __ldg(p.tables + (size_t)b * p.N + kk / p.T);
  }
  return 0;
}

template <int NVP, int BK, bool kPaged>
__global__ void __launch_bounds__(NT, 1)
attn_kernel(const __grid_constant__ Params p) {
  constexpr int PANEL = BK * 128;        // bytes of a 64-column K/V panel
  constexpr int NS_ = BK / 2;            // S accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int KP = p.KP, NS = p.stages;
  const uint32_t stage_bytes = (KP + NVP) * PANEL;
  const uint32_t sKV = sQ + KP * Q_PANEL;
  const uint32_t bars = sKV + NS * stage_bytes;  // full[4], empty[4], q
  const uint32_t qbar = bars + 16 * MAX_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qtile * BQ;

  // the key tiles some row of the block can see
  const int qf = p.q_offset + q0;
  const int k_end = p.causal ? min(p.Sk, qf + BQ) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, qf - p.window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);                     // producer's arrive
      mbar_init(bars + 8 * (MAX_STAGES + s), 8);      // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: its first warp issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, KP * Q_PANEL);
      for (int c = 0; c < KP; ++c)
        tma_load(sQ + c * Q_PANEL, &p.tq, qbar, c * 64, q0, b * p.Hq + h);
    }
    int stage = 0, phase = 0;
    int page = page_of<BK, kPaged>(p, t_begin, b, lane, t_end);
    for (int t = t_begin; t < t_end; ++t) {
      const int next = page_of<BK, kPaged>(p, t + 1, b, lane, t_end);
      mbar_wait(bars + 8 * (MAX_STAGES + stage), phase ^ 1);
      const uint32_t sK = sKV + stage * stage_bytes;
      if (lane == 0) mbar_expect_tx(bars + 8 * stage, stage_bytes);
      __syncwarp();
      issue_tile<NVP, BK, kPaged>(p, t, b, hk, lane, page, sK,
                                  sK + KP * PANEL, bars + 8 * stage);
      page = next;
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64); this
  // thread holds rows r0 and r0 + 8 of the wgmma accumulator layout
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int qpos0 = p.q_offset + q0 + r0, qpos1 = qpos0 + 8;
  const int qf_w = p.q_offset + q0 + wg * 64;
  const int ke_w = p.causal ? min(p.Sk, qf_w + 64) : p.Sk;
  const int kb_w = p.window > 0 ? max(0, qf_w - p.window + 1) : 0;
  const int cbase = 2 * (lane % 4);
  const float cl2 = p.scale_log2;

  float o[NVP][32];
#pragma unroll
  for (int c = 0; c < NVP; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  const uint32_t sQw = sQ + wg * 64 * 128;
  int stage = 0, phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    mbar_wait(bars + 8 * stage, phase);
    const int k0 = t * BK;
    const uint32_t sK = sKV + stage * stage_bytes;
    const uint32_t sV = sK + KP * PANEL;
    if (k0 < ke_w && k0 + BK > kb_w) {
      float s[NS_];
#pragma unroll
      for (int j = 0; j < NS_; ++j) s[j] = 0.f;
      reg_fence(s);
      wg_fence();
      for (int c = 0; c < KP; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, sw128_desc(sQw + c * Q_PANEL + kk * 32, 16),
                   sw128_desc(sK + c * PANEL + kk * 32, 16), c | kk);
      }
      wg_commit();
      wg_wait0();
      reg_fence(s);

      const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qf_w) ||
                        (p.window > 0 && k0 <= qf_w + 63 - p.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS_; ++j) {
        float x = s[j] * cl2;
        if (edge) {
          const int kpos = k0 + 8 * (j / 4) + cbase + (j % 2);
          const int qpos = (j & 2) ? qpos1 : qpos0;
          const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
          x = ok ? x : -INFINITY;
        }
        s[j] = x;
        if (j & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row with no key so far keeps max -inf: exponents against 0
      const float z0 = n0 == -INFINITY ? 0.f : n0;
      const float z1 = n1 == -INFINITY ? 0.f : n1;
      const float corr0 = exp2f(m0 - z0), corr1 = exp2f(m1 - z1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t ph[NS_ / 2], pl[NS_ / 2];
#pragma unroll
      for (int i = 0; i < NS_ / 2; ++i) {
        const bool hi_row = i & 1;  // s[2i], s[2i + 1]: row r0 + 8 * bit 1
        const float z = hi_row ? z1 : z0;
        const float a = exp2f(s[2 * i] - z), c = exp2f(s[2 * i + 1] - z);
        if (hi_row)
          sum1 += a + c;
        else
          sum0 += a + c;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            a - __low2float(hi), c - __high2float(hi));
        ph[i] = bf16x2_bits(hi);
        pl[i] = bf16x2_bits(lo);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int c = 0; c < NVP; ++c) {
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= (j & 2) ? corr1 : corr0;
        reg_fence(o[c]);
      }
      wg_fence();
#pragma unroll
      for (int c = 0; c < NVP; ++c) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv =
              sw128_desc(sV + c * PANEL + kk * 16 * 128, PANEL);
          wgmma_rs(o[c], ph + 4 * kk, dv);
          wgmma_rs(o[c], pl + 4 * kk, dv);
        }
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int c = 0; c < NVP; ++c) reg_fence(o[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + stage));
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row that saw no key (l == 0) writes 0, as the TPU kernel does
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  __nv_bfloat16* op =
      p.o + ((size_t)(b * p.Hq + h) * p.Sq + q0) * p.Dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (q0 + r >= p.Sq) continue;
    const float inv = half ? inv1 : inv0;
#pragma unroll
    for (int c = 0; c < NVP; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = c * 64 + 8 * g + cbase;
        if (col < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * p.Dv + col) =
              __floats2bfloat162_rn(o[c][4 * g + 2 * half] * inv,
                                    o[c][4 * g + 2 * half + 1] * inv);
      }
  }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the
// runtime's entry-point query, so the library links no -lcuda.
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D bf16 map over (d2, d1, d0) (d0 contiguous) with boxes of 64
// columns x `rows` x 1 and the 128-byte swizzle; out-of-range elements
// read as zeros.
static inline cudaError_t make_map(CUtensorMap* map, const void* ptr,
                                   uint64_t d0, uint64_t d1, uint64_t d2,
                                   uint32_t rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the core takes: head dims multiples of 8 up to 256 (TMA rows are
// 16-byte multiples), 16-byte aligned pointers.
static inline bool shapes_ok(int Dk, int Dv, int Hq, int Hkv,
                             std::initializer_list<const void*> ptrs) {
  if (Dk <= 0 || Dv <= 0 || Dk > 256 || Dv > 256 || Dk % 8 || Dv % 8)
    return false;
  if (Hkv <= 0 || Hq % Hkv) return false;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

template <int NVP, int BK, bool kPaged>
cudaError_t launch(Params& p, int B, cudaStream_t stream) {
  const int stage_bytes = (p.KP + NVP) * BK * 128;
  p.stages = (SMEM_MAX - SMEM_FIXED - p.KP * Q_PANEL) / stage_bytes;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  if (p.stages < 2) return cudaErrorInvalidValue;
  const size_t smem =
      SMEM_FIXED + (size_t)p.KP * Q_PANEL + (size_t)p.stages * stage_bytes;
  auto kernel = attn_kernel<NVP, BK, kPaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(p.Sq, BQ), p.Hq, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NVP, bool kPaged>
cudaError_t launch_tile(Params& p, int B, cudaStream_t stream) {
  if (tile_keys(p.KP, NVP) == 128) {
    if constexpr (tile_keys(1, NVP) == 128)
      return launch<NVP, 128, kPaged>(p, B, stream);
  }
  return launch<NVP, 64, kPaged>(p, B, stream);
}

// Instantiate for the output width (64 columns, 32 accumulators a thread,
// per wgmma N panel) and the tile.
template <bool kPaged>
cudaError_t dispatch(Params& p, int B, int Dk, cudaStream_t stream) {
  p.KP = (Dk + 63) / 64;
  switch ((p.Dv + 63) / 64) {
    case 1: return launch_tile<1, kPaged>(p, B, stream);
    case 2: return launch_tile<2, kPaged>(p, B, stream);
    case 3: return launch_tile<3, kPaged>(p, B, stream);
    case 4: return launch_tile<4, kPaged>(p, B, stream);
  }
  return cudaErrorInvalidValue;
}

static inline float scale_log2(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

}  // namespace flash_wgmma
