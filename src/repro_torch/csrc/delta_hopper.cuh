// Chunked gated delta rule for Hopper, in two phases: the core of both
// instances of csrc/delta.cu (rows 3 and 5 of the port's kernel table):
//
//   * kMasked = true replaces src/repro/kernels/delta.py::delta_chunked_fused
//     (pallas_call at delta.py:218): KDA prefill over right-padded rows;
//   * kMasked = false replaces delta_chunked (pallas_call at delta.py:155):
//     every row valid, the forward of training.
//
//     S_t = a_t (I - beta_t k_t k_t^T) S_{t-1} + beta_t k_t v_t^T
//     o_t = q_t S_t
//
// Per chunk of C = 64 rows, with cs the chunk's cumulative log decay,
// gamma = exp(cs), A = diag(beta) (K K^T . D_strict) and T = (I + A)^-1,
// the reference's WY form (src/repro/kernels/delta.py:1-18) rewrites as
//
//     W = T diag(beta) (K . gamma)     U = T diag(beta) V
//     M = Q K^T . D_incl               kscale = exp(cs_C - cs), g = exp(cs_C)
//     u = U - W S                      o = gamma . (Q S) + M u
//     S <- g S + K^T (kscale . u)
//
// where W, U, M, gamma, kscale and g depend on the chunk's own rows only.
//
// What bounds it on the H100: the recurrence.  The bytes (q, k, v once,
// o once) take ~0.1 ms at (2, 56, 4096, 128) and the products a few
// GFLOP, but the 64 chunks of a head must run in order.  The earlier SIMT
// kernel spent most of each chunk step on work that never depended on
// the state (a 63-step forward substitution, K K^T and Q K^T, recomputed
// by each of a head's 4 column blocks) and ran every product in float32
// on the CUDA cores.  This core takes all of that off the sequential path:
//
// * Phase 1 (wy_kernel), one block a (batch, head, chunk): B*H*S/64
//   blocks, enough to fill the card.  It loads the chunk's rows, neutral-
//   izes rows at or past the length (k, v, beta, log_a -> 0; rows past S
//   also q), scans the decays, forms K K^T and Q K^T on the tensor cores
//   (mma.sync m16n8k16, bf16 in, float32 accumulators), solves T in
//   float32 by 16 x 16 blocks (the diagonal ones by forward substitution,
//   the rest by block substitution), then W and U as T-products on the
//   tensor cores.  It writes -W, M, q, k^T (as mma A fragments, in bf16
//   parts where a value is not exact in bf16), U (float32, in accumulator
//   order), gamma, kscale and g to a workspace the wrapper allocates.
// * Phase 2 (state_kernel), one block a (batch, head, 32 state columns):
//   the float32 state slice lives in the warps' accumulators (row group w
//   owns key rows 16 (w MT) .. 16 (w MT + MT) - 1; bf16 splits the 32
//   columns over two warps) and, in bf16 parts, in shared memory as the
//   B operand.  Per chunk: u = U + (-W) S and Q S (row group w: chunk
//   rows 16w..16w+15), o = gamma . QS + M u, S = g S +
//   K^T (kscale . u): 64 x dk x 32 and 64 x 64 x 32 products on mma.sync.
//   The next chunk's record (fragments, vectors and this slice's U) is
//   copied into the other half of a 2-stage ring by cp.async while this
//   one computes; where two stages do not fit in 227 KB (dk > 128 in bf16,
//   dk > 64 in float32) the warps read the record from global memory.
//
// mma.sync and not wgmma: every operand of phase 2 is either produced in
// the block each chunk (the state and u, split into bf16 parts) or
// written by phase 1 already in the register order the instruction takes,
// so each warp loads its own fragments with 16-byte reads and no operand
// needs wgmma's swizzled shared-memory tiles; the products are 16-row
// slices per warp.
//
// Precision: T, W, M, U, S and u are float32, and the products take each
// in bf16 parts (PT, PW, PM, PS, PU below); q, k and v are exact in bf16
// when the input is bf16 and are then taken whole.  float32 inputs take
// the same tensor-core route with q, k and v in two parts.  The plain
// mirror of both phases (kernels/delta.py: wy_factors, state_pass,
// emulate=True, PARTS) rounds the same way and holds this against the
// float32 tolerances on the CPU.
//
// Padding: the key dim to DKP = 64 MT (MT = 1..4, dk <= 256) and the value
// dim to slices of 32, with zeros; S to whole chunks (rows past S are
// neutral).  Nothing here allocates or copies to the host (graph-safe).
#pragma once
#include "common.cuh"

namespace delta_hopper {

constexpr int C = 64;          // chunk rows
constexpr int NT = 128;        // threads of a phase-1 block (4 warps)
constexpr int SLICE = 32;      // state columns of a phase-2 block
constexpr int FRAG = 512;      // bytes of one warp's 16 x 16 bf16 A fragment
constexpr int VEC_FLOATS = 144;  // gamma[64], kscale[64], g, padding
constexpr int TS = 72;         // row stride (float) of A and T in phase 1
constexpr int VB = 64;         // value columns of phase 1's v tile
constexpr int SMEM_MAX = 232448;

// bf16 parts of each float32 operand of the tensor-core products: T in
// phase 1's W and U, the stored W and M, the state S, and u and kscale . u
// (each part is the rounding of what the earlier ones leave; a product of
// an A in PA parts and a B in PB parts sums the part products i, j with
// i + j < max(PA, PB)).  Two parts keep ~16 of float32's 24 bits, three
// all of them.  With two everywhere the kernel met every float32
// tolerance, but its bf16 outputs differed from the float32 plain
// version's rounding far more often than float32 in another order does,
// which moved kimi-linear's bf16 prefill logits by 15 % through its expert
// routing on the H100.  T, M and u, whose errors reach the outputs
// directly, take three (1.3 %, as the earlier SIMT kernel); the state
// keeps two.  The card test test_delta_core_rounds_like_float32
// (tests/test_torch_gpu.py) holds this kernel's rate of such flips, and
// test_delta_core_parts_are_the_mirrors that kernels/delta.py's PARTS
// (prfaas_delta_parts) are these.
constexpr int PT = 3, PW = 2, PM = 3, PS = 2, PU = 3;

template <typename T>
struct Parts {
  static constexpr int value = 1;  // bf16 q, k, v: exact, unsplit
};
template <>
struct Parts<float> {
  static constexpr int value = 2;  // float32 q, k, v: hi + lo
};

// The workspace (one record a chunk, then U) and both phases' shared
// memory, for the key dim padded to 64 * MT.  The wrapper asks
// workspace() for its size (prfaas_delta_workspace_bytes).
template <typename T, int MT>
struct Layout {
  static constexpr int P = Parts<T>::value;
  static constexpr int KT = 4 * MT;  // 16-wide tiles of the padded key dim
  static constexpr int DKP = 64 * MT;
  // record: -W [warp][kt][part], M [warp][kt <= warp][part] (M is
  // lower triangular: warp w's rows need its first w + 1 tiles, 10 in
  // all), q [warp][kt][part], k^T [key tile][row tile 4][part] (each a
  // FRAG), then the vectors
  static constexpr int W = 0;
  static constexpr int M = W + 4 * KT * PW * FRAG;
  static constexpr int Q = M + 10 * PM * FRAG;
  static constexpr int K = Q + 4 * KT * P * FRAG;
  static constexpr int VEC = K + KT * 4 * P * FRAG;
  static constexpr int REC = VEC + VEC_FLOATS * 4;
  // U of one chunk: [warp][n-tile of 8 columns][lane] float4; a slice's 4
  // n-tiles of all warps make one stage's USLICE bytes
  static constexpr int USLICE = 4 * 4 * FRAG;
  static constexpr int STAGE = REC + USLICE;
  // bytes of the workspace of B * H * ceil(S / C) chunks: their records,
  // then their U in dv's slices
  static size_t workspace(int B, int H, int S, int dv) {
    return (size_t)B * H * cdiv(S, C) *
           ((size_t)REC + (size_t)cdiv(dv, SLICE) * USLICE);
  }
  // phase 2: the state's PS parts as B operand [column][key], stride SB;
  // u's and kscale . u's PU parts [column][row], stride UB
  static constexpr int SB = DKP + 8;
  static constexpr int UB = C + 8;
  static constexpr int P2_FIXED = PS * SLICE * SB * 2 + 2 * PU * SLICE * UB * 2;
  static constexpr bool kStaged = 2 * STAGE + P2_FIXED <= SMEM_MAX;
  static constexpr int P2_SMEM = (kStaged ? 2 * STAGE : 0) + P2_FIXED;
  // phase 2's warps: four row groups, each in CG column groups of NTW
  // n-tiles of 8 state columns.  bf16 takes two (8 warps: two instruction
  // streams on each SM sub-partition), which ran faster on the H100;
  // float32, with its q and k^T products in two parts, ran slower so
  static constexpr int CG = P == 1 ? 2 : 1;
  static constexpr int NTW = 4 / CG;
  static constexpr int NT2 = NT * CG;
  // phase 1: k [part][row][key] (stride KS), then q in a region that A and
  // T (float32, stride TS) reuse once Q K^T is formed, a VB-column block
  // of v [part][row][column] (stride VS), then cs, beta, gamma
  static constexpr int KS = DKP + 8;
  static constexpr int VS = VB + 8;
  static constexpr int QBYTES = P * C * KS * 2;
  static constexpr int ATBYTES = 2 * C * TS * 4;
  static constexpr int P1_K = 0;
  static constexpr int P1_R = P1_K + P * C * KS * 2;
  static constexpr int P1_V = P1_R + (QBYTES > ATBYTES ? QBYTES : ATBYTES);
  static constexpr int P1_VEC = P1_V + P * C * VS * 2;
  static constexpr int P1_SMEM = P1_VEC + 3 * C * 4;
};

// ---- fragments and products ----------------------------------------------

// offset of M's fragment (warp w, k-tile kt <= w, part p) in a record
__device__ __forceinline__ int m_frag(int w, int kt, int p) {
  return ((w * (w + 1) / 2 + kt) * PM + p) * FRAG;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x as N bf16 parts
template <int N>
__device__ __forceinline__ void splitn(float x, __nv_bfloat16 (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = __float2bfloat16(x);
    x -= __bfloat162float(p[i]);
  }
}

// a pair as N registers of bf16 parts (the lower k index in the low half)
template <int N>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    r[i] = bits(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack16(const __nv_bfloat16* lo_k,
                                           const __nv_bfloat16* hi_k) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo_k) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi_k) << 16);
}

// d += a b, m16n8k16, bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B with A in PA bf16 parts and B in PB: the part products i, j
// with i + j < max(PA, PB), largest first (two parts each: hi.hi + hi.lo
// + lo.hi)
template <int PA, int PB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][2]) {
  constexpr int K = PA > PB ? PA : PB;
#pragma unroll
  for (int o = 0; o < K; ++o)
#pragma unroll
    for (int i = 0; i < PA; ++i)
      if (o - i >= 0 && o - i < PB) mma(d, a[i], b[o - i][0], b[o - i][1]);
}

// A fragment of rows r0.., columns k0.. of a row-major bf16 tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int r0,
                                       int k0, int stride, int g, int t) {
  const __nv_bfloat16* p = base + (r0 + g) * stride + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment (k 16 x n 8) of a tile stored [n][k] (k contiguous)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2],
                                          const __nv_bfloat16* base, int n0,
                                          int k0, int stride, int g, int t) {
  const __nv_bfloat16* p = base + (n0 + g) * stride + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (k 16 x n 8) of a tile stored [k][n] (n contiguous)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2],
                                          const __nv_bfloat16* base, int k0,
                                          int n0, int stride, int g, int t) {
  const __nv_bfloat16* p = base + (k0 + 2 * t) * stride + n0 + g;
  b[0] = pack16(p, p + stride);
  b[1] = pack16(p + 8 * stride, p + 9 * stride);
}

// this lane's 16 bytes of a FRAG
__device__ __forceinline__ void ld_frag(uint32_t (&a)[4], const char* frag,
                                        int lane) {
  const uint4 x = *reinterpret_cast<const uint4*>(frag + lane * 16);
  a[0] = x.x;
  a[1] = x.y;
  a[2] = x.z;
  a[3] = x.w;
}

__device__ __forceinline__ void st_frag(char* frag, int lane,
                                        const uint32_t (&a)[4]) {
  *reinterpret_cast<uint4*>(frag + lane * 16) =
      make_uint4(a[0], a[1], a[2], a[3]);
}

// the A fragment of a k-tile, in N parts, from two accumulator n-tiles
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&n0)[4],
                                         const float (&n1)[4], float sign,
                                         uint32_t (&a)[N][4]) {
  const float x[8] = {n0[0], n0[1], n0[2], n0[3], n1[0], n1[1], n1[2], n1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t parts[N];
    split_pair<N>(sign * x[2 * r], sign * x[2 * r + 1], parts);
#pragma unroll
    for (int p = 0; p < N; ++p) a[p][r] = parts[p];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(
                   dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows 0..63 of a chunk of x (row stride `cols`, row 0 at `src`),
// columns col0..col0 + WIDTH - 1, into a [part][64][STRIDE] bf16 tile (hi,
// and lo for float32), zero at rows >= lim and columns >= cols.  16-byte
// loads, all of a thread's issued before any is stored, when `cols` is a
// multiple of 16 bytes and `src` is aligned (one round trip to memory);
// element loads otherwise.
template <typename T, int P, int WIDTH, int STRIDE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int lim, int cols, int col0,
                                          int tid) {
  constexpr int EPV = 16 / sizeof(T), CPR = WIDTH / EPV;
  constexpr int N = C * CPR / NT;  // 16-byte pieces a thread
  static_assert(C * CPR % NT == 0, "tile not a whole number of passes");
  if (cols % EPV == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int u0 = 0; u0 < N; u0 += 8) {
      uint4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u0 + u < N) {
          const int idx = tid + (u0 + u) * NT, i = idx / CPR,
                    d = col0 + (idx % CPR) * EPV;
          x[u] = (i < lim && d < cols)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           src + (size_t)i * cols + d))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u0 + u < N) {
          const int idx = tid + (u0 + u) * NT;
          const int at = (idx / CPR) * STRIDE + (idx % CPR) * EPV;
          if constexpr (P == 1) {
            *reinterpret_cast<uint4*>(dst + at) = x[u];
          } else {
            uint32_t a[2], b[2];
            split_pair<2>(__uint_as_float(x[u].x), __uint_as_float(x[u].y), a);
            split_pair<2>(__uint_as_float(x[u].z), __uint_as_float(x[u].w), b);
            *reinterpret_cast<uint2*>(dst + at) = make_uint2(a[0], b[0]);
            *reinterpret_cast<uint2*>(dst + C * STRIDE + at) =
                make_uint2(a[1], b[1]);
          }
        }
      }
    }
  } else {
    for (int idx = tid; idx < C * WIDTH; idx += NT) {
      const int i = idx / WIDTH, d = col0 + idx % WIDTH;
      const float x =
          (i < lim && d < cols) ? to_f32(src[(size_t)i * cols + d]) : 0.f;
      const int at = i * STRIDE + idx % WIDTH;
      __nv_bfloat16 parts[P];
      splitn<P>(x, parts);
      dst[at] = parts[0];
      if constexpr (P == 2) dst[C * STRIDE + at] = parts[1];
    }
  }
}

// T = (I + A)^-1 for A strictly lower triangular (64 x 64, row stride TS),
// by 16 x 16 blocks: warp w inverts the diagonal block w by forward
// substitution (a lane a column, in registers), then the blocks below the
// diagonal follow one distance d = i - j at a time, T_ij = -T_ii Y_ij with
// Y_ij = sum_{k=j}^{i-1} A_ik T_kj, each thread a 1 x 4 strip.  Y_ij is
// kept in the unused block (j, i) above the diagonal.  The critical path
// is 16 rows and 3 levels, on all 128 threads.
__device__ __forceinline__ void solve_blocked(const float* __restrict__ As,
                                              float* __restrict__ Ts,
                                              int tid) {
  const int lane = tid & 31, w = tid >> 5;
  if (lane < 16) {
    const int o = 16 * w;
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float s = (i == lane) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < i; ++j)
        s = fmaf(-As[(o + i) * TS + o + j], x[j], s);
      x[i] = s;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) Ts[(o + i) * TS + o + lane] = x[i];
  }
  __syncthreads();
  for (int d = 1; d < 4; ++d) {
    const int strips = (4 - d) * 64;  // (4 - d) blocks of 16 rows x 4 strips
    for (int e = tid; e < strips; e += NT) {
      const int j = e >> 6, r = (e >> 2) & 15, c4 = 4 * (e & 3), i = j + d;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = j; k < i; ++k) {
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const float a = As[(16 * i + r) * TS + 16 * k + m];
          const float4 t = *reinterpret_cast<const float4*>(
              Ts + (16 * k + m) * TS + 16 * j + c4);
          y.x = fmaf(a, t.x, y.x);
          y.y = fmaf(a, t.y, y.y);
          y.z = fmaf(a, t.z, y.z);
          y.w = fmaf(a, t.w, y.w);
        }
      }
      *reinterpret_cast<float4*>(Ts + (16 * j + r) * TS + 16 * i + c4) = y;
    }
    __syncthreads();
    for (int e = tid; e < strips; e += NT) {
      const int j = e >> 6, r = (e >> 2) & 15, c4 = 4 * (e & 3), i = j + d;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const float a = Ts[(16 * i + r) * TS + 16 * i + m];
        const float4 t = *reinterpret_cast<const float4*>(
            Ts + (16 * j + m) * TS + 16 * i + c4);
        y.x = fmaf(-a, t.x, y.x);
        y.y = fmaf(-a, t.y, y.y);
        y.z = fmaf(-a, t.z, y.z);
        y.w = fmaf(-a, t.w, y.w);
      }
      *reinterpret_cast<float4*>(Ts + (16 * i + r) * TS + 16 * j + c4) = y;
    }
    __syncthreads();
  }
}

// ---- phase 1: the chunk's factors, all chunks in parallel ------------------

// three blocks an SM: 168 registers and a few bytes spilled ran faster on
// the H100 than two blocks an SM without spills
template <typename T, bool kMasked, int MT>
__global__ void __launch_bounds__(NT, 3)
wy_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ log_a,
          const float* __restrict__ beta, const int* __restrict__ lengths,
          char* __restrict__ ws, char* __restrict__ wsU, int H, int S,
          int dk, int dv) {
  using L = Layout<T, MT>;
  constexpr int P = L::P, KT = L::KT, DKP = L::DKP, KS = L::KS, VS = L::VS;
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_K);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_R);
  float* As = reinterpret_cast<float*>(smem + L::P1_R);  // after Q K^T
  float* Ts = As + C * TS;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_V);
  float* cs = reinterpret_cast<float*>(smem + L::P1_VEC);
  float* bt = cs + C;
  float* gm = bt + C;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, NC = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t bhc = bh * NC + c;
  const int len = kMasked ? max(0, min(lengths[b], S)) : S;
  const int r0 = c * C;
  const int ntv = (dv + SLICE - 1) / SLICE * 4;  // n-tiles of padded dv
  char* rec = ws + bhc * L::REC;
  float4* Uc = reinterpret_cast<float4*>(wsU + bhc * (size_t)ntv * 4 * FRAG);

  if (w == 0) {
    // inclusive scan of the chunk's log decays, two rows a lane
    const int i0 = 2 * lane;
    const bool v0 = r0 + i0 < len, v1 = r0 + i0 + 1 < len;
    const float a0 = v0 ? log_a[bh * S + r0 + i0] : 0.f;
    const float a1 = v1 ? log_a[bh * S + r0 + i0 + 1] : 0.f;
    const float pair = a0 + a1;
    float x = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    cs[i0] = x - pair + a0;
    cs[i0 + 1] = x;
    bt[i0] = v0 ? beta[bh * S + r0 + i0] : 0.f;
    bt[i0 + 1] = v1 ? beta[bh * S + r0 + i0 + 1] : 0.f;
  }
  // the chunk's rows: q kept below S; k and v neutralized at or past the
  // length (the first VB columns of v now, the rest with U below)
  const size_t row0 = bh * S + r0;
  load_tile<T, P, DKP, KS>(Qs, q + row0 * dk, S - r0, dk, 0, tid);
  load_tile<T, P, DKP, KS>(Ks, k + row0 * dk, len - r0, dk, 0, tid);
  load_tile<T, P, VB, VS>(Vs, v + row0 * dv, len - r0, dv, 0, tid);
  __syncthreads();
  if (tid < C) {
    float* vec = reinterpret_cast<float*>(rec + L::VEC);
    gm[tid] = expf(cs[tid]);
    vec[tid] = gm[tid];
    vec[C + tid] = expf(cs[C - 1] - cs[tid]);
    if (tid == 0) vec[2 * C] = expf(cs[C - 1]);
  }

  // K K^T and Q K^T for this warp's rows 16w..16w+15 (columns past them
  // are zero in A and M and are skipped); q's fragments go out as they are
  float kk[8][4], qk[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) kk[nt][e] = qk[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t ak[P][4], aq[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      load_a(ak[p], Ks + p * C * KS, 16 * w, 16 * kt, KS, g, t);
      load_a(aq[p], Qs + p * C * KS, 16 * w, 16 * kt, KS, g, t);
      st_frag(rec + L::Q + ((w * KT + kt) * P + p) * FRAG, lane, aq[p]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt <= 2 * w + 1) {
        uint32_t bk[P][2];
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_b_nk(bk[p], Ks + p * C * KS, 8 * nt, 16 * kt, KS, g, t);
        mma_split<P, P>(kk[nt], ak, bk);
        mma_split<P, P>(qk[nt], aq, bk);
      }
    }
  }
  __syncthreads();  // q is read: A and T take its place

  // A = diag(beta) (K K^T . D_strict) to shared memory; M = Q K^T . D_incl
  // straight out as fragments
  const int ia = 16 * w + g, ib = ia + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ia : ib, j = 8 * nt + 2 * t + (e & 1);
      const float dec = j <= i ? expf(cs[i] - cs[j]) : 0.f;
      a[e] = j < i ? bt[i] * (kk[nt][e] * dec) : 0.f;
      qk[nt][e] = j <= i ? qk[nt][e] * dec : 0.f;
    }
    *reinterpret_cast<float2*>(As + ia * TS + 8 * nt + 2 * t) =
        make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(As + ib * TS + 8 * nt + 2 * t) =
        make_float2(a[2], a[3]);
  }
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    if (kt <= w) {
      uint32_t a[PM][4];
      acc_to_a<PM>(qk[2 * kt], qk[2 * kt + 1], 1.f, a);
#pragma unroll
      for (int p = 0; p < PM; ++p)
        st_frag(rec + L::M + m_frag(w, kt, p), lane, a[p]);
    }
  }
  __syncthreads();
  solve_blocked(As, Ts, tid);

  // W = T diag(beta gamma) K, 64 key columns at a time, out as -W
  // fragments; T is lower triangular, so this warp's rows need k-tiles
  // 0..w only
  {
    uint32_t tw[4][PT][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (r & 1) ? ib : ia;
        const int j = 16 * kt + 2 * t + ((r & 2) ? 8 : 0);
        const float2 x = *reinterpret_cast<const float2*>(Ts + i * TS + j);
        uint32_t parts[PT];
        split_pair<PT>(x.x * bt[j] * gm[j], x.y * bt[j + 1] * gm[j + 1],
                       parts);
#pragma unroll
        for (int p = 0; p < PT; ++p) tw[kt][p][r] = parts[p];
      }
    }
#pragma unroll
    for (int grp = 0; grp < MT; ++grp) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt <= w) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            uint32_t bk[P][2];
#pragma unroll
            for (int p = 0; p < P; ++p)
              load_b_kn(bk[p], Ks + p * C * KS, 16 * kt, 64 * grp + 8 * nt,
                        KS, g, t);
            mma_split<PT, P>(acc[nt], tw[kt], bk);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[PW][4];
        acc_to_a<PW>(acc[2 * j], acc[2 * j + 1], -1.f, a);
        const int kt = 4 * grp + j;
#pragma unroll
        for (int p = 0; p < PW; ++p)
          st_frag(rec + L::W + ((w * KT + kt) * PW + p) * FRAG, lane, a[p]);
      }
    }
  }

  // k^T as the A fragments of the state update: key tile m, row tile r
  for (int f = w; f < KT * 4; f += 4) {
    const int m = f >> 2, r = f & 3;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const __nv_bfloat16* base = Ks + p * C * KS;
      const __nv_bfloat16* x = base + (16 * r + 2 * t) * KS + 16 * m + g;
      uint32_t a[4];
      a[0] = pack16(x, x + KS);
      a[1] = pack16(x + 8, x + KS + 8);
      a[2] = pack16(x + 8 * KS, x + 9 * KS);
      a[3] = pack16(x + 8 * KS + 8, x + 9 * KS + 8);
      st_frag(rec + L::K + ((m * 4 + r) * P + p) * FRAG, lane, a);
    }
  }

  // U = T diag(beta) V, VB value columns at a time, out in accumulator
  // order
  uint32_t tu[4][PT][4];
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = (r & 1) ? ib : ia, j = 16 * kt + 2 * t + ((r & 2) ? 8 : 0);
      const float2 x = *reinterpret_cast<const float2*>(Ts + i * TS + j);
      uint32_t parts[PT];
      split_pair<PT>(x.x * bt[j], x.y * bt[j + 1], parts);
#pragma unroll
      for (int p = 0; p < PT; ++p) tu[kt][p][r] = parts[p];
    }
  }
  for (int vb = 0; vb * (VB / 8) < ntv; ++vb) {
    if (vb > 0) {
      __syncthreads();  // the previous block of v is read
      load_tile<T, P, VB, VS>(Vs, v + row0 * dv, len - r0, dv, vb * VB, tid);
      __syncthreads();
    }
    const int nts = min(VB / 8, ntv - vb * (VB / 8));
    float acc[VB / 8][4];
#pragma unroll
    for (int nt = 0; nt < VB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt <= w) {
#pragma unroll
        for (int nt = 0; nt < VB / 8; ++nt) {
          if (nt < nts) {
            uint32_t bv[P][2];
#pragma unroll
            for (int p = 0; p < P; ++p)
              load_b_kn(bv[p], Vs + p * C * VS, 16 * kt, 8 * nt, VS, g, t);
            mma_split<PT, P>(acc[nt], tu[kt], bv);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < VB / 8; ++nt)
      if (nt < nts)
        Uc[(w * ntv + vb * (VB / 8) + nt) * 32 + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  }
}

// ---- phase 2: the state pass, chunks in order ------------------------------

template <int MT, int SB, int NTW>
__device__ __forceinline__ void put_state(const float (&st)[MT][NTW][4],
                                          __nv_bfloat16* Sb, int w, int cg,
                                          int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * (w * MT + mt) + g + (e >= 2 ? 8 : 0);
        const int n = 8 * (cg * NTW + j) + 2 * t + (e & 1);
        __nv_bfloat16 parts[PS];
        splitn<PS>(st[mt][j][e], parts);
#pragma unroll
        for (int p = 0; p < PS; ++p) Sb[p * SLICE * SB + n * SB + d] = parts[p];
      }
}

template <typename T, int MT>
__global__ void __launch_bounds__(Layout<T, MT>::NT2)
state_kernel(const char* __restrict__ ws, const char* __restrict__ wsU,
             const float* __restrict__ s0, T* __restrict__ o,
             float* __restrict__ sT, int H, int S, int dk, int dv, int NC) {
  using L = Layout<T, MT>;
  constexpr int P = L::P, KT = L::KT, SB = L::SB, UB = L::UB;
  constexpr int NTW = L::NTW, NT2 = L::NT2;
  extern __shared__ __align__(16) char smem[];
  char* ring = smem;  // [2][STAGE] when staged
  // the state's PS parts, u's PU parts, kscale . u's PU parts
  __nv_bfloat16* Sb =
      reinterpret_cast<__nv_bfloat16*>(smem + (L::kStaged ? 2 * L::STAGE : 0));
  __nv_bfloat16* Ub = Sb + PS * SLICE * SB;
  __nv_bfloat16* Kb = Ub + PU * SLICE * UB;

  // warp: chunk rows and key rows of group w, state columns 8 NTW cg ..
  const int tid = threadIdx.x, lane = tid & 31, w = (tid >> 5) & 3;
  const int cg = tid >> 7, g = lane >> 2, t = lane & 3;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int ntv = (dv + SLICE - 1) / SLICE * 4;
  const int col0 = s * SLICE;
  const size_t ubytes = (size_t)ntv * 4 * FRAG;  // U of one chunk

  float st[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * (w * MT + mt) + g + (e >= 2 ? 8 : 0);
        const int col = col0 + 8 * (cg * NTW + j) + 2 * t + (e & 1);
        st[mt][j][e] =
            (d < dk && col < dv) ? s0[(bh * dk + d) * dv + col] : 0.f;
      }
  put_state<MT, SB, NTW>(st, Sb, w, cg, g, t);

  auto fetch = [&](int c, char* dst) {
    const char* src = ws + (bh * NC + c) * L::REC;
    for (int off = tid * 16; off < L::REC; off += NT2 * 16)
      cp_async16(dst + off, src + off);
    const char* us = wsU + (bh * NC + c) * ubytes;
    for (int off = tid * 16; off < L::USLICE; off += NT2 * 16) {
      const int wq = off / (4 * FRAG), in = off % (4 * FRAG);
      cp_async16(dst + L::REC + off, us + (wq * ntv + 4 * s) * FRAG + in);
    }
    cp_commit();
  };
  if constexpr (L::kStaged) {
    if (NC > 0) fetch(0, ring);
  }

  const int ia = 16 * w + g, ib = ia + 8;
  for (int c = 0; c < NC; ++c) {
    const char* rec;
    const char* ub;  // this warp's 4 n-tiles of U, FRAG apart
    if constexpr (L::kStaged) {
      cp_wait_all();
      __syncthreads();
      if (c + 1 < NC) fetch(c + 1, ring + ((c + 1) & 1) * L::STAGE);
      rec = ring + (c & 1) * L::STAGE;
      ub = rec + L::REC + (w * 4 + cg * NTW) * FRAG;
    } else {
      __syncthreads();
      rec = ws + (bh * NC + c) * L::REC;
      ub = wsU + (bh * NC + c) * ubytes +
           (size_t)(w * ntv + 4 * s + cg * NTW) * FRAG;
    }

    // u = U + (-W) S and Q S, rows 16w..16w+15
    float u[NTW][4], oc[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float4 x =
          *reinterpret_cast<const float4*>(ub + nt * FRAG + lane * 16);
      u[nt][0] = x.x;
      u[nt][1] = x.y;
      u[nt][2] = x.z;
      u[nt][3] = x.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[nt][e] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t aw[PW][4], aq[P][4];
#pragma unroll
      for (int p = 0; p < PW; ++p)
        ld_frag(aw[p], rec + L::W + ((w * KT + kt) * PW + p) * FRAG, lane);
#pragma unroll
      for (int p = 0; p < P; ++p)
        ld_frag(aq[p], rec + L::Q + ((w * KT + kt) * P + p) * FRAG, lane);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t bs[PS][2];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          load_b_nk(bs[p], Sb + p * SLICE * SB, 8 * (cg * NTW + nt),
                    16 * kt, SB, g, t);
        mma_split<PW, PS>(u[nt], aw, bs);
        mma_split<P, PS>(oc[nt], aq, bs);
      }
    }
    const float* vec = reinterpret_cast<const float*>(rec + L::VEC);
    const float ga = vec[ia], gb = vec[ib];
    const float ka = vec[C + ia], kb = vec[C + ib], gC = vec[2 * C];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int n = 8 * (cg * NTW + nt) + 2 * t + (e & 1);
        oc[nt][e] *= e < 2 ? ga : gb;
        __nv_bfloat16 pu[PU], pk[PU];
        splitn<PU>(u[nt][e], pu);
        splitn<PU>(u[nt][e] * (e < 2 ? ka : kb), pk);
#pragma unroll
        for (int p = 0; p < PU; ++p) {
          Ub[p * SLICE * UB + n * UB + i] = pu[p];
          Kb[p * SLICE * UB + n * UB + i] = pk[p];
        }
      }
    }
    __syncthreads();

    // o = gamma . QS + M u (M is lower triangular: k-tiles 0..w)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt <= w) {
        uint32_t am[PM][4];
#pragma unroll
        for (int p = 0; p < PM; ++p)
          ld_frag(am[p], rec + L::M + m_frag(w, kt, p), lane);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          uint32_t bu[PU][2];
#pragma unroll
          for (int p = 0; p < PU; ++p)
            load_b_nk(bu[p], Ub + p * SLICE * UB, 8 * (cg * NTW + nt),
                      16 * kt, UB, g, t);
          mma_split<PM, PU>(oc[nt], am, bu);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = c * C + (e < 2 ? ia : ib);
        const int col = col0 + 8 * (cg * NTW + nt) + 2 * t + (e & 1);
        if (row < S && col < dv)
          o[(bh * S + row) * dv + col] = from_f32<T>(oc[nt][e]);
      }
    }

    // S = g S + K^T (kscale . u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] *= gC;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t bk[NTW][PU][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int p = 0; p < PU; ++p)
          load_b_nk(bk[nt][p], Kb + p * SLICE * UB, 8 * (cg * NTW + nt),
                    16 * kt, UB, g, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ak[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          ld_frag(ak[p],
                  rec + L::K + (((w * MT + mt) * 4 + kt) * P + p) * FRAG,
                  lane);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          mma_split<P, PU>(st[mt][nt], ak, bk[nt]);
      }
    }
    put_state<MT, SB, NTW>(st, Sb, w, cg, g, t);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * (w * MT + mt) + g + (e >= 2 ? 8 : 0);
        const int col = col0 + 8 * (cg * NTW + nt) + 2 * t + (e & 1);
        if (d < dk && col < dv) sT[(bh * dk + d) * dv + col] = st[mt][nt][e];
      }
}

// Both phases on `stream`.  `ws` holds ws_bytes (Layout::workspace);
// returns cudaErrorInvalidValue if that is too few.
template <typename T, bool kMasked, int MT>
cudaError_t run(const T* q, const T* k, const T* v, const float* log_a,
                const float* beta, const int* lengths, const float* s0, T* o,
                float* sT, char* ws, long long ws_bytes, int B, int H, int S,
                int dk, int dv, cudaStream_t stream) {
  using L = Layout<T, MT>;
  const int NC = cdiv(S, C);
  const int dvp = cdiv(dv, SLICE) * SLICE;
  const size_t chunks = (size_t)B * H * NC;
  if ((size_t)ws_bytes < L::workspace(B, H, S, dv))
    return cudaErrorInvalidValue;
  char* wsU = ws + chunks * L::REC;
  cudaError_t err;
  if (NC > 0) {
    auto k1 = wy_kernel<T, kMasked, MT>;
    if ((err = set_smem(k1, L::P1_SMEM)) != cudaSuccess) return err;
    k1<<<dim3(NC, H, B), NT, L::P1_SMEM, stream>>>(q, k, v, log_a, beta,
                                                    lengths, ws, wsU, H, S,
                                                    dk, dv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto k2 = state_kernel<T, MT>;
  if ((err = set_smem(k2, L::P2_SMEM)) != cudaSuccess) return err;
  k2<<<dim3(dvp / SLICE, H, B), L::NT2, L::P2_SMEM, stream>>>(
      ws, wsU, s0, o, sT, H, S, dk, dv, NC);
  return cudaGetLastError();
}

}  // namespace delta_hopper
