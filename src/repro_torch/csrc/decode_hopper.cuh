// bf16 one-query flash-decode core for Hopper, shared by the dense
// (decode_attn.cu) and the paged (paged_decode_attn.cu) decode kernels;
// their float32 path keeps the SIMT core of decode_core.cuh.
//
// Computes softmax(scale * q K^T) V over each row's live keys
// [max(0, L - window), min(L, S)), L = lengths[b], for G = Hq / Hkv query
// heads per cache head, Dk != Dv, as src/repro/kernels/decode_attn.py:65
// and src/repro/kernels/paged_decode_attn.py:71 do.  Where a key row lives
// is the policy `Keys` (dense strides or a page table): `keys.row(b, hk,
// j)` is the index of key j of (row b, cache head hk) in units of one key
// row, the same for K (Dk wide) and V (Dv wide).
//
// What bounds it on the H100: bytes.  Every live key is (Dk + Dv) * 2
// bytes for 2 * G * (Dk + Dv) FLOPs: 64 FLOP/byte at absorbed MLA (G 64),
// 4 at GQA (G 4), 1 at MHA: all under the card's ~295 ridge, so the time
// is the stream of the live keys from HBM.  Two designs, by group size:
//
// * G >= 16 (MLA): tensor cores.  Streaming at HBM rate takes ~214
//   TFLOP/s at 64 FLOP/byte, above the float32 SIMT peak (67), so both
//   products run on wgmma with all 64 heads of a head tile as the 64 rows
//   of the tile: the latent is read once a row.  S = Q K^T is m64nBKk16
//   over Dk padded to a multiple of 16 (zero columns), O += P V is
//   m64n64k16 with P from registers, split into bf16 hi + lo parts as
//   flash_wgmma.cuh does for the 2e-3 tolerance.  The 64 x Dv float32
//   output is split across two consumer warpgroups (Dv / 2 columns each),
//   which both compute S (QK^T is cheap at this intensity).  A producer
//   warpgroup fills a ring of K/V tiles with 16-byte cp.async into the
//   128-byte-swizzled layout wgmma reads, one key row per 128 / BK
//   threads, so a paged tile is read at each key's page and keys past the
//   length are zero-filled, never read.  BK is 32 keys (two stages beside
//   Q: 213 KB at Dk 536 / Dv 472), 16 where that does not fit.
// * G < 16 (GQA, MHA): a bf16 stream on the CUDA cores.  At 1-4
//   FLOP/byte what matters is bytes in flight.  Each warp is a worker of
//   its own: its lanes cp.async the 16-byte chunks of its keys into a
//   4-stage ring that only they read (no barrier but cp.async's own wait
//   group), C lanes share a key row (8 bf16 each) and reduce the dot
//   product with shuffles, and each lane keeps the running max, sum and
//   its accumulator columns of up to 8 heads in registers.
//
// Work is split by rows, each by its own length alone: row b's live keys
// are cut into tiles (BK keys, or one warp stage), and its c_b tiles into
// n_b = min(MR, ceil(c_b / RMIN)) runs, run j starting at tile j (c_b /
// n_b) + min(j, c_b % n_b).  MR (most runs a row) and RMIN (fewest tiles a
// run) come from the launch's static shapes, so where a row's partials
// begin and end, and the order the combine merges them, never depend on
// another row's length: a row's bits are the same whatever its batch-mates
// hold.  Run j of row b writes its partial (max, sum, unnormalised
// accumulator) to slot b MR + j.  The runs of all rows, numbered in row
// order, are dealt to the NW workers by their first tiles: worker i takes
// the runs that start in its even share [i T / NW, (i + 1) T / NW) of the
// T live tiles, so a worker's load is its share plus at most one run.  The
// plan derives from `lengths` on the device (no host copy).  A row with no
// live key writes 0.  Keys past the length, and pages past it, are never
// read; the dead rows of a partly live tile are zero in shared memory and
// their scores are -inf by selection.
#pragma once
#include <initializer_list>

#include "common.cuh"

namespace decode_hopper {

// ---- each row's runs, numbered across rows --------------------------------

// runs of a row of c live tiles: at most MR, none shorter than RMIN tiles
// (bar the last ones of a row shorter than RMIN n)
__device__ __forceinline__ int row_runs(int c, int MR, int RMIN) {
  return c > 0 ? min(MR, (c + RMIN - 1) / RMIN) : 0;
}
// first tile of run j of n over c tiles (j = n gives c)
__device__ __forceinline__ int run_start(int c, int n, int j) {
  return j * (c / n) + min(j, c % n);
}

struct Walk {
  const int* lengths;
  int S, window, TK, MR, RMIN;
  int b = -1, lo = 0, len = 0, count = 0, nrun = 0, run = 0;
  long long first = 0;  // global index of row b's first tile
  long long end = 0;    // global index past run `run` of row b

  __device__ __forceinline__ void span(int r, int& l, int& n) const {
    const int L = max(__ldg(lengths + r), 0);
    n = min(L, S);
    l = window > 0 ? max(0, L - window) : 0;
  }
  __device__ __forceinline__ int tiles(int r) const {
    int l, n;
    span(r, l, n);
    return n > l ? (n - l + TK - 1) / TK : 0;
  }
  // moves to the row and run that hold tile t (t never decreases)
  __device__ __forceinline__ void seek(long long t) {
    while (t >= first + count) {
      first += count;
      ++b;
      span(b, lo, len);
      count = len > lo ? (len - lo + TK - 1) / TK : 0;
      nrun = row_runs(count, MR, RMIN);
      run = -1;
      end = first;
    }
    while (t >= end) {
      ++run;
      end = first + run_start(count, nrun, run + 1);
    }
  }
  // tile t's keys [k0, k1) of row b (after seek)
  __device__ __forceinline__ int k0(long long t) const {
    return lo + (int)(t - first) * TK;
  }
  // the partial slot of the run seek found
  __device__ __forceinline__ int slot() const { return b * MR + run; }

  // the first run start at or past global tile x (T where none is)
  __device__ long long run_ceil(int B, long long x) const {
    long long f = 0;
    for (int r = 0; r < B; ++r) {
      const int c = tiles(r);
      if (x < f + c) {
        const int n = row_runs(c, MR, RMIN), q = c / n, rem = c % n;
        const int u = (int)(x - f), big = rem * (q + 1);
        int j = u < big ? u / (q + 1) : rem + (u - big) / q;
        if (run_start(c, n, j) < u) ++j;
        return f + run_start(c, n, j);
      }
      f += c;
    }
    return f;
  }
};

// Worker i of NW: the runs whose first tiles lie in its even share of the
// T live tiles, [i q + min(i, T % NW), ...) with q = T / NW; returns their
// tiles [t0, t1).
__device__ __forceinline__ void worker_run(const Walk& w, int B, int NW,
                                           int i, long long& t0,
                                           long long& t1) {
  long long total = 0;
  for (int r = 0; r < B; ++r) total += w.tiles(r);
  const long long q = total / NW, rem = total - q * NW;
  const long long s0 = i * q + min((long long)i, rem);
  const long long s1 = s0 + q + (i < rem ? 1 : 0);
  t0 = w.run_ceil(B, s0);
  t1 = w.run_ceil(B, s1);
}

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
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

__device__ __forceinline__ void bf16x8_to_f32(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// 128-byte swizzle of a panel of 128-byte rows: 16-byte chunk c of row r
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// ---- G < 16: the bf16 stream on the CUDA cores ---------------------------

constexpr int STREAM_WARPS = 4;  // workers a block
constexpr int STREAM_STAGES = 4;

// C lanes read one key row, XC 16-byte chunks each; NP passes of 32 / C
// keys make one stage (a tile) of a warp
__host__ __device__ constexpr int stream_tile(int C, int XC) {
  return (4 / XC) * (32 / C);
}
__host__ __device__ constexpr int stream_smem(int XC) {
  return STREAM_WARPS * STREAM_STAGES * (4 / XC) * 2 * XC * 32 * 16;
}

template <int C, int XC, int GBM, typename Keys>
__global__ void __launch_bounds__(STREAM_WARPS * 32, GBM * XC >= 8 ? 2 : 3)
stream_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths, float* __restrict__ part_acc,
              float* __restrict__ part_ml, Keys keys, int B, int Hq, int Hkv,
              int Dk, int Dv, int GB, int NW, int MR, int RMIN, int window,
              float scale_log2) {
  constexpr int NP = 4 / XC;       // passes a stage
  constexpr int KPP = 32 / C;      // keys a pass
  constexpr int TK = NP * KPP;     // keys a tile
  constexpr int NS = STREAM_STAGES;
  constexpr int SLOT = 32 * 16;    // one chunk per lane
  extern __shared__ __align__(16) uint8_t smem_raw[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / C, sub = lane % C;
  const int G = Hq / Hkv;
  const int htiles = (G + GB - 1) / GB;
  const int hk = blockIdx.y / htiles, ht = blockIdx.y % htiles;
  const int gn = min(GB, G - ht * GB);
  const int h0 = hk * G + ht * GB;
  const int worker = blockIdx.x * STREAM_WARPS + warp;
  const int nkc = Dk / 8, nvc = Dv / 8;
  // this lane's ring: [stage][pass][K x XC, V x XC] chunks
  const uint32_t ring = smem_u32(smem_raw) +
                        warp * NS * NP * 2 * XC * SLOT + lane * 16;

  Walk lw{lengths, keys.S, window, TK, MR, RMIN}, cw = lw;
  long long t0, t1;
  worker_run(lw, B, NW, worker, t0, t1);

  // the key rows of the next tile to load, resolved a tile before its
  // loads are issued so that a page-table read hides behind a tile's work
  size_t nrow[NP];
  auto resolve = [&](long long t) {
    lw.seek(t);
    const int k0 = lw.k0(t), k1 = min(lw.len, k0 + TK);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = k0 + p * KPP + gi;
      nrow[p] = j < k1 ? keys.row(lw.b, hk, j) : ~(size_t)0;
    }
  };
  auto load = [&](int stage) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool live = nrow[p] != ~(size_t)0;
      const size_t r = live ? nrow[p] : 0;
      const __nv_bfloat16* kr = k + r * Dk;
      const __nv_bfloat16* vr = v + r * Dv;
      const uint32_t slot = ring + (stage * NP + p) * 2 * XC * SLOT;
#pragma unroll
      for (int x = 0; x < XC; ++x) {
        const int ch = sub + C * x;
        if (ch < nkc)
          cp_async16(slot + x * SLOT, live ? kr + ch * 8 : k, live ? 16 : 0);
        if (ch < nvc)
          cp_async16(slot + (XC + x) * SLOT, live ? vr + ch * 8 : v,
                     live ? 16 : 0);
      }
    }
  };

  float qr[GBM][XC][8], acc[GBM][XC][8], m[GBM], l[GBM];
  int cur = -1;

  // merge the lane groups (each saw other keys of the run), then group 0
  // writes the partial of the run in slot `cur`
  auto flush = [&]() {
#pragma unroll
    for (int off = C; off < 32; off *= 2) {
#pragma unroll
      for (int g = 0; g < GBM; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float z = mx == -INFINITY ? 0.f : mx;
        const float a = exp2f(m[g] - z), c = exp2f(mo - z);
        m[g] = mx;
        l[g] = l[g] * a + lo * c;
#pragma unroll
        for (int x = 0; x < XC; ++x)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float o = __shfl_xor_sync(0xffffffffu, acc[g][x][e], off);
            acc[g][x][e] = acc[g][x][e] * a + o * c;
          }
      }
    }
    const size_t seg = (size_t)cur;
    if (lane < C) {
#pragma unroll
      for (int g = 0; g < GBM; ++g) {
        if (g >= gn) break;
        const size_t row = seg * Hq + h0 + g;
        if (lane == 0) {
          part_ml[row * 2] = m[g];
          part_ml[row * 2 + 1] = l[g];
        }
#pragma unroll
        for (int x = 0; x < XC; ++x) {
          const int ch = sub + C * x;
          if (ch < nvc) {
            float4* dst = reinterpret_cast<float4*>(part_acc + row * Dv + ch * 8);
            dst[0] = make_float4(acc[g][x][0], acc[g][x][1], acc[g][x][2],
                                 acc[g][x][3]);
            dst[1] = make_float4(acc[g][x][4], acc[g][x][5], acc[g][x][6],
                                 acc[g][x][7]);
          }
        }
      }
    }
  };

  if (t0 < t1) resolve(t0);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (t0 + s < t1) {
      load(s);
      if (t0 + s + 1 < t1) resolve(t0 + s + 1);
    }
    cp_commit();
  }
  int stage = 0;
  for (long long t = t0;; ++t) {
    // one flush site, at each run change and after the last tile
    if (t < t1) cw.seek(t);
    if (cur >= 0 && (t == t1 || cw.slot() != cur)) flush();
    if (t == t1) break;
    const long long tl = t + NS - 1;
    if (tl < t1) {
      load((stage + NS - 1) % NS);
      if (tl + 1 < t1) resolve(tl + 1);
    }
    cp_commit();
    cp_wait<NS - 1>();   // this lane's chunks of tile t have landed

    if (cw.slot() != cur) {
      cur = cw.slot();
#pragma unroll
      for (int g = 0; g < GBM; ++g) {
#pragma unroll
        for (int x = 0; x < XC; ++x) {
          const int ch = sub + C * x;
          float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (g < gn && ch < nkc)
            bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(
                              q + ((size_t)cw.b * Hq + h0 + g) * Dk + ch * 8)),
                          f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            qr[g][x][e] = f[e] * scale_log2;
            acc[g][x][e] = 0.f;
          }
        }
        m[g] = -INFINITY;
        l[g] = 0.f;
      }
    }
    const int k0 = cw.k0(t), nl = min(cw.len, k0 + TK) - k0;
    const uint32_t base = ring + stage * NP * 2 * XC * SLOT;

    // scores (log2 units) of this group's key in each pass
    float sc[NP][GBM];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float kf[XC][8];
#pragma unroll
      for (int x = 0; x < XC; ++x) {
        uint4 w = make_uint4(0, 0, 0, 0);
        if (sub + C * x < nkc)
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                       : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
                       : "r"(base + (p * 2 * XC + x) * SLOT));
        bf16x8_to_f32(w, kf[x]);
      }
#pragma unroll
      for (int g = 0; g < GBM; ++g) {
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < XC; ++x)
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qr[g][x][e], kf[x][e], s);
#pragma unroll
        for (int off = C / 2; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        sc[p][g] = (p * KPP + gi < nl) ? s : -INFINITY;
      }
    }
    // one rescale a tile
#pragma unroll
    for (int g = 0; g < GBM; ++g) {
      float mt = m[g];
#pragma unroll
      for (int p = 0; p < NP; ++p) mt = fmaxf(mt, sc[p][g]);
      const float z = mt == -INFINITY ? 0.f : mt;
      const float corr = exp2f(m[g] - z);
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        sc[p][g] = exp2f(sc[p][g] - z);
        sum += sc[p][g];
      }
      m[g] = mt;
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int x = 0; x < XC; ++x)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][x][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int x = 0; x < XC; ++x) {
        if (sub + C * x >= nvc) continue;
        uint4 w;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
                     : "r"(base + (p * 2 * XC + XC + x) * SLOT));
        float vf[8];
        bf16x8_to_f32(w, vf);
#pragma unroll
        for (int g = 0; g < GBM; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][x][e] = fmaf(sc[p][g], vf[e], acc[g][x][e]);
      }
    }
    stage = (stage + 1) % NS;
  }
  cp_wait<0>();
}

// ---- G >= 16: tensor cores -----------------------------------------------

constexpr int TC_THREADS = 384;      // 2 consumer warpgroups + producer
constexpr int TC_PRODUCER_REGS = 56; // setmaxnreg: 56 * 128 + 224 * 256
constexpr int TC_CONSUMER_REGS = 224;//   = 168 * 384 registers a block
constexpr int TC_MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448;     // a block's shared memory (H100)
constexpr int TC_SMEM_FIXED = 1024 + 16 * TC_MAX_STAGES;  // align, barriers

__host__ __device__ constexpr int tc_stage_bytes(int KP, int NVP, int BK) {
  return (KP + NVP) * BK * 128;
}
// keys a tile: 32 where two stages fit beside Q, else 16
__host__ __device__ constexpr int tc_tile(int KP, int NVP) {
  return TC_SMEM_FIXED + KP * 8192 + 2 * tc_stage_bytes(KP, NVP, 32) <=
                 SMEM_MAX
             ? 32
             : 16;
}
__host__ __device__ constexpr int tc_stages(int KP, int NVP, int BK) {
  return (SMEM_MAX - TC_SMEM_FIXED - KP * 8192) / tc_stage_bytes(KP, NVP, BK) <
                 TC_MAX_STAGES
             ? (SMEM_MAX - TC_SMEM_FIXED - KP * 8192) /
                   tc_stage_bytes(KP, NVP, BK)
             : TC_MAX_STAGES;
}

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
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DH_D8(o)                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),         \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define DH_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define DH_R16 DH_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define DH_R32                                                             \
  DH_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"

// S (64 x 16 | 32, float32) = or += A (smem, K-major) B (smem, K-major)^T
__device__ __forceinline__ void wgmma_s(float (&d)[8], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" DH_R8
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : DH_D8(0)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s(float (&d)[16], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" DH_R16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : DH_D8(0), DH_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}
// O (64 x 64, float32) += P (registers, bf16 pairs) V (smem, MN-major)
__device__ __forceinline__ void wgmma_o(float (&d)[32], const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" DH_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DH_D8(0), DH_D8(8), DH_D8(16), DH_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef DH_D8
#undef DH_R8
#undef DH_R16
#undef DH_R32

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// NH: 64-column output panels a consumer warpgroup owns (Dv <= 128 NH)
template <int NH, int BK, typename Keys>
__global__ void __launch_bounds__(TC_THREADS, 1)
tc_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const int* __restrict__ lengths, float* __restrict__ part_acc,
          float* __restrict__ part_ml, Keys keys, int B, int Hq, int Hkv,
          int Dk, int Dv, int NW, int MR, int RMIN, int stages, int window,
          float scale_log2) {
  constexpr int PANEL = BK * 128;   // bytes of a 64-column K/V panel
  constexpr int NSA = BK / 2;       // S accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const int KP = (Dk + 63) / 64, NVP = (Dv + 63) / 64;
  const int kc16 = (Dk + 15) / 16 * 2;  // K/Q chunks the products read
  const int nkc = Dk / 8, nvc = Dv / 8;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t stage_bytes = (KP + NVP) * PANEL;
  const uint32_t sKV = sQ + KP * 8192;
  const uint32_t bars = sKV + stages * stage_bytes;  // full[4], empty[4]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = Hq / Hkv;
  const int htiles = (G + 63) / 64;
  const int hk = blockIdx.y / htiles, ht = blockIdx.y % htiles;
  const int gn = min(64, G - ht * 64);
  const int h0 = hk * G + ht * 64;
  const int worker = blockIdx.x;

  Walk walk{lengths, keys.S, window, BK, MR, RMIN};
  long long t0, t1;
  worker_run(walk, B, NW, worker, t0, t1);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 128);                      // producer threads
      mbar_init(bars + 8 * (TC_MAX_STAGES + s), 8);      // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: RT threads a key row
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(TC_PRODUCER_REGS));
    constexpr int RT = 128 / BK;
    const int pt = tid - 256, r = pt / RT, c0 = pt % RT;
    int stage = 0, phase = 0, prev = 0;
    for (long long t = t0; t < t1; ++t) {
      mbar_wait(bars + 8 * (TC_MAX_STAGES + stage), phase ^ 1);
      walk.seek(t);
      const int j = walk.k0(t) + r;
      const bool live = j < min(walk.len, walk.k0(t) + BK);
      const size_t row = live ? keys.row(walk.b, hk, j) : 0;
      const __nv_bfloat16* kr = k + row * Dk;
      const __nv_bfloat16* vr = v + row * Dv;
      const uint32_t sK = sKV + stage * stage_bytes, sV = sK + KP * PANEL;
      for (int ch = c0; ch < kc16; ch += RT) {
        const bool rd = live && ch < nkc;
        cp_async16(sK + (ch >> 3) * PANEL + swz(r, ch & 7),
                   rd ? kr + ch * 8 : k, rd ? 16 : 0);
      }
      for (int ch = c0; ch < nvc; ch += RT)
        cp_async16(sV + (ch >> 3) * PANEL + swz(r, ch & 7),
                   live ? vr + ch * 8 : v, live ? 16 : 0);
      cp_commit();
      if (t > t0) {  // the previous tile has landed: hand it to wgmma
        cp_wait<1>();
        fence_async_smem();
        mbar_arrive(bars + 8 * prev);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (t1 > t0) {
      cp_wait<0>();
      fence_async_smem();
      mbar_arrive(bars + 8 * prev);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(TC_CONSUMER_REGS));

  // consumers: both warpgroups compute all 64 rows of S; warpgroup wg owns
  // output panels [wg NH, wg NH + NH).  This thread holds rows r0, r0 + 8.
  const int wg = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cbase = 2 * (lane % 4);

  float o[NH][32];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int cur = -1;

  auto flush = [&]() {
    float s0 = l0, s1 = l1;
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const size_t seg = (size_t)cur;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= gn) continue;
      const size_t row = seg * Hq + h0 + r;
      if (wg == 0 && lane % 4 == 0) {
        part_ml[row * 2] = half ? m1 : m0;
        part_ml[row * 2 + 1] = half ? s1 : s0;
      }
#pragma unroll
      for (int c = 0; c < NH; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = (wg * NH + c) * 64 + 8 * g + cbase;
          if (col < Dv)
            *reinterpret_cast<float2*>(part_acc + row * Dv + col) =
                make_float2(o[c][4 * g + 2 * half], o[c][4 * g + 2 * half + 1]);
        }
    }
  };

  int stage = 0, phase = 0;
  for (long long t = t0;; ++t) {
    // one flush site, at each run change and after the last tile
    if (t < t1) walk.seek(t);
    if (cur >= 0 && (t == t1 || walk.slot() != cur)) flush();
    if (t == t1) break;
    if (walk.slot() != cur) {
      cur = walk.slot();
      // every consumer is done with the last run's Q (its wgmma waited)
      asm volatile("bar.sync 1, 256;" ::: "memory");
      for (int idx = tid; idx < 64 * kc16; idx += 256) {
        const int r = idx / kc16, ch = idx - r * kc16;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (r < gn && ch < nkc)
          w = __ldg(reinterpret_cast<const uint4*>(
              q + ((size_t)walk.b * Hq + h0 + r) * Dk + ch * 8));
        const uint32_t dst = sQ + (ch >> 3) * 8192 + swz(r, ch & 7);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
                     "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
                     : "memory");
      }
      fence_async_smem();
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int c = 0; c < NH; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
    }
    const int nl = min(walk.len, walk.k0(t) + BK) - walk.k0(t);
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t sK = sKV + stage * stage_bytes, sV = sK + KP * PANEL;

    float s[NSA];
#pragma unroll
    for (int j = 0; j < NSA; ++j) s[j] = 0.f;
    reg_fence(s);
    wg_fence();
    for (int ks = 0; ks < kc16 / 2; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_s(s, sw128_desc(sQ + (ks >> 2) * 8192 + off, 16),
              sw128_desc(sK + (ks >> 2) * PANEL + off, 16), ks);
    }
    wg_commit();
    wg_wait0();
    reg_fence(s);

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NSA; ++j) {
      const int kpos = 8 * (j / 4) + cbase + (j % 2);
      const float x = kpos < nl ? s[j] * scale_log2 : -INFINITY;
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
    const float z0 = n0 == -INFINITY ? 0.f : n0;
    const float z1 = n1 == -INFINITY ? 0.f : n1;
    const float corr0 = exp2f(m0 - z0), corr1 = exp2f(m1 - z1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t ph[NSA / 2], pl[NSA / 2];
#pragma unroll
    for (int i = 0; i < NSA / 2; ++i) {
      const bool hi_row = i & 1;  // s[2i], s[2i + 1]: row r0 + 8 * bit 1
      const float z = hi_row ? z1 : z0;
      const float a = exp2f(s[2 * i] - z), c = exp2f(s[2 * i + 1] - z);
      if (hi_row)
        sum1 += a + c;
      else
        sum0 += a + c;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a - __low2float(hi),
                                                      c - __high2float(hi));
      ph[i] = bf16x2_bits(hi);
      pl[i] = bf16x2_bits(lo);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] *= (j & 2) ? corr1 : corr0;
      reg_fence(o[c]);
    }
    wg_fence();
    // a warpgroup's panels past NVP repeat the last one (their columns
    // are never written): no branch around a wgmma, which would serialize
    // them all
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      const int panel = min(wg * NH + c, NVP - 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(sV + panel * PANEL + kk * 16 * 128,
                                       PANEL);
        wgmma_o(o[c], ph + 4 * kk, dv);
        wgmma_o(o[c], pl + 4 * kk, dv);
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NH; ++c) reg_fence(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (TC_MAX_STAGES + stage));
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ---- combine: each row's runs -> out (B, Hq, Dv) -------------------------

constexpr int COMBINE_THREADS = 128;  // one float4 of Dv <= 512 a thread

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, o) : x + o;
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < COMBINE_THREADS / 32; ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        T* __restrict__ out, const int* __restrict__ lengths, int B, int S,
        int window, int TK, int MR, int RMIN, int Hq, int Dv) {
  __shared__ float s_w[COMBINE_THREADS], s_red[COMBINE_THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // this row's runs, slots b MR + [0, n): from its own length alone, so the
  // merge below has the same shape whatever the other rows hold
  const Walk w{lengths, S, window, TK, MR, RMIN};
  const int lo = 0, hi = row_runs(w.tiles(b), MR, RMIN) - 1;
  const size_t s0 = (size_t)b * MR;
  auto ml = [&](int i) { return part_ml + ((s0 + i) * Hq + h) * 2; };
  float mt = -INFINITY;
  for (int i = lo + tid; i <= hi; i += COMBINE_THREADS)
    mt = fmaxf(mt, ml(i)[0]);
  mt = block_reduce(mt, true, s_red);
  float den = 0.f;
  for (int i = lo + tid; i <= hi; i += COMBINE_THREADS)
    den += exp2f(ml(i)[0] - mt) * ml(i)[1];
  den = block_reduce(den, false, s_red);
  // a row with no live key (den == 0) writes 0, as the TPU kernel does
  const float inv = den == 0.f ? 0.f : 1.f / den;
  // thread = (segment lane sl, float4 column c4): narrow rows spread the
  // segments over SL lanes, so more loads are in flight
  int cols = 1;
  while (cols < Dv / 4) cols *= 2;
  const int SL = COMBINE_THREADS / cols;
  const int c = 4 * (tid % cols), sl = tid / cols;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = lo; base <= hi; base += COMBINE_THREADS) {
    const int n = min(COMBINE_THREADS, hi - base + 1);
    __syncthreads();
    if (tid < n) s_w[tid] = exp2f(ml(base + tid)[0] - mt) * inv;
    __syncthreads();
    if (c < Dv) {
#pragma unroll 4
      for (int j = sl; j < n; j += SL) {
        const float4 a = *reinterpret_cast<const float4*>(
            part_acc + ((s0 + base + j) * Hq + h) * Dv + c);
        const float wj = s_w[j];
        acc.x = fmaf(wj, a.x, acc.x);
        acc.y = fmaf(wj, a.y, acc.y);
        acc.z = fmaf(wj, a.z, acc.z);
        acc.w = fmaf(wj, a.w, acc.w);
      }
    }
  }
  __shared__ float4 s_acc[COMBINE_THREADS];
  s_acc[tid] = acc;
  __syncthreads();
  if (sl == 0 && c < Dv) {
    for (int l = 1; l < SL; ++l) {
      const float4 a = s_acc[tid + l * cols];
      acc.x += a.x;
      acc.y += a.y;
      acc.z += a.z;
      acc.w += a.w;
    }
    T* o = out + ((size_t)b * Hq + h) * Dv + c;
    o[0] = from_f32<T>(acc.x);
    o[1] = from_f32<T>(acc.y);
    o[2] = from_f32<T>(acc.z);
    o[3] = from_f32<T>(acc.w);
  }
}

// ---- host side -----------------------------------------------------------

// The stream instance of (Dk, Dv): C lanes a key row, XC chunks a lane.
static inline void stream_shape(int Dk, int Dv, int& C, int& XC) {
  const int ch = ((Dk > Dv ? Dk : Dv) + 7) / 8;
  C = 8;
  while (C < ch && C < 32) C *= 2;
  XC = 1;
  while (32 * XC < ch) XC *= 2;
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_acc, *part_ml;
  int B, Hq, Hkv, Dk, Dv, heads, workers, window, tile, runs, rmin;
  float scale_log2;
};

template <int C, int XC, int GBM, typename Keys>
cudaError_t launch_stream(const Args& a, Keys keys, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (a.tile != stream_tile(C, XC) || a.workers % STREAM_WARPS ||
      a.heads > GBM)
    return cudaErrorInvalidValue;
  auto kernel = stream_kernel<C, XC, GBM, Keys>;
  const int smem = stream_smem(XC);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.workers / STREAM_WARPS, a.Hkv * ((G + a.heads - 1) / a.heads));
  kernel<<<grid, STREAM_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.lengths, a.part_acc,
      a.part_ml, keys, a.B, a.Hq, a.Hkv, a.Dk, a.Dv, a.heads, a.workers,
      a.runs, a.rmin, a.window, a.scale_log2);
  return cudaGetLastError();
}

template <int C, int XC, typename Keys>
cudaError_t stream_heads(const Args& a, Keys keys, cudaStream_t stream) {
  if (a.heads <= 1) return launch_stream<C, XC, 1>(a, keys, stream);
  if (a.heads <= 2) return launch_stream<C, XC, 2>(a, keys, stream);
  if constexpr (XC <= 2)
    if (a.heads <= 4) return launch_stream<C, XC, 4>(a, keys, stream);
  if constexpr (XC == 1)
    if (a.heads <= 8) return launch_stream<C, XC, 8>(a, keys, stream);
  return cudaErrorInvalidValue;
}

template <int NH, int BK, typename Keys>
cudaError_t launch_tc(const Args& a, Keys keys, cudaStream_t stream) {
  const int KP = (a.Dk + 63) / 64, NVP = (a.Dv + 63) / 64;
  const int stages = tc_stages(KP, NVP, BK);
  if (a.tile != BK || stages < 2) return cudaErrorInvalidValue;
  const size_t smem = TC_SMEM_FIXED + (size_t)KP * 8192 +
                      (size_t)stages * tc_stage_bytes(KP, NVP, BK);
  auto kernel = tc_kernel<NH, BK, Keys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.workers, a.Hkv * ((G + 63) / 64));
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.lengths, a.part_acc,
      a.part_ml, keys, a.B, a.Hq, a.Hkv, a.Dk, a.Dv, a.workers, a.runs,
      a.rmin, stages, a.window, a.scale_log2);
  return cudaGetLastError();
}

template <int NH, typename Keys>
cudaError_t tc_tiles(const Args& a, Keys keys, cudaStream_t stream) {
  const int KP = (a.Dk + 63) / 64, NVP = (a.Dv + 63) / 64;
  if (tc_tile(KP, NVP) == 32) return launch_tc<NH, 32>(a, keys, stream);
  return launch_tc<NH, 16>(a, keys, stream);
}

// What the core takes: head dims multiples of 8 (16-byte chunks) with Dk
// <= 1024 and Dv <= 512, 16-byte aligned pointers.
static inline bool shapes_ok(const Args& a) {
  if (a.Dk <= 0 || a.Dv <= 0 || a.Dk > 1024 || a.Dv > 512 || a.Dk % 8 ||
      a.Dv % 8 || a.Hkv <= 0 || a.Hq % a.Hkv || a.workers < 1 || a.heads < 1 ||
      a.runs < 1 || a.rmin < 1)
    return false;
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The partials of B runs slots (a row's runs at b runs + j), then the
// combine.
template <typename Keys>
cudaError_t launch(const Args& a, Keys keys, cudaStream_t stream) {
  if (!shapes_ok(a)) return cudaErrorInvalidValue;
  const int G = a.Hq / a.Hkv;
  cudaError_t err;
  if (G >= 16) {
    switch ((a.Dv + 127) / 128) {
      case 1: err = tc_tiles<1>(a, keys, stream); break;
      case 2: err = tc_tiles<2>(a, keys, stream); break;
      case 3: err = tc_tiles<3>(a, keys, stream); break;
      case 4: err = tc_tiles<4>(a, keys, stream); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    int C, XC;
    stream_shape(a.Dk, a.Dv, C, XC);
    if (XC == 1 && C == 8) err = stream_heads<8, 1>(a, keys, stream);
    else if (XC == 1 && C == 16) err = stream_heads<16, 1>(a, keys, stream);
    else if (XC == 1) err = stream_heads<32, 1>(a, keys, stream);
    else if (XC == 2) err = stream_heads<32, 2>(a, keys, stream);
    else if (XC == 4) err = stream_heads<32, 4>(a, keys, stream);
    else err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  combine<__nv_bfloat16><<<dim3(a.Hq, a.B), COMBINE_THREADS, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<__nv_bfloat16*>(a.out), a.lengths,
      a.B, keys.S, a.window, a.tile, a.runs, a.rmin, a.Hq, a.Dv);
  return cudaGetLastError();
}

static inline float scale_log2(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

}  // namespace decode_hopper
