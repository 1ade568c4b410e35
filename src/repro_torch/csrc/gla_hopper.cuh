// Chunked gated linear attention for Hopper, in three phases: the bf16
// core of both instances of csrc/gla.cu (rows 6 and 7 of the port's kernel
// table):
//
//   * kMasked = true replaces src/repro/kernels/gla.py::gla_chunked_fused
//     (pallas_call at gla.py:185): Mamba2 prefill over right-padded rows;
//   * kMasked = false replaces gla_chunked (pallas_call at gla.py:126):
//     every row valid, the forward of training.
//
//     S_t = exp(log_a_t) S_{t-1} + k_t v_t^T ,   o_t = q_t S_t
//
// Per chunk c of C = 64 rows, with cs the chunk's inclusive cumulative log
// decay, gamma = exp(cs), kscale = exp(cs_C - cs) and g = exp(cs_C) (every
// exponent <= 0, no 1/gamma: src/repro/kernels/gla.py:25-44),
//
//     dS_c = (K . kscale)^T V                     (the chunk's own rows)
//     S_c  = g_c S_{c-1} + dS_c                   (elementwise)
//     o    = (Q K^T . D) V + gamma . (Q S_{c-1})
//
// with D[i,j] = exp(cs_i - cs_j) for j <= i, else 0.
//
// Unlike the delta rule nothing but the elementwise line reads the state,
// so the products run for all chunks at once and only that line is
// sequential.
//
// What bounds it on the H100: bytes.  The products are ~10 MFLOP a chunk
// on the tensor cores; the chunk's increment and entering state (dk x dv
// float32 each, 32 KB at zamba2's 64 x 128) make a round trip through
// device memory, ~4x the bytes of q, k, v and o.  The earlier SIMT kernel
// walked the chunks of a head in one block (128 blocks at a zamba2
// prefill), recomputing Q K^T in float32 for each of 4 column slices.
//
// * Phase 1 (increment_kernel), one block a (batch, head, chunk): loads k
//   and v with 16-byte loads, neutralizes rows at or past the length (k, v,
//   log_a -> 0, by selection), scans the decays in one warp, and forms dS^T
//   = V^T (K . kscale) on mma.sync m16n8k16 (bf16 in, float32
//   accumulators; v whole, k . kscale in PK bf16 parts).  It writes dS^T
//   in accumulator order ([16 columns][8 keys][lane] float4) and g to a
//   workspace the wrapper allocates (Layout::workspace).
// * Phase 2 (state_kernel), one thread a float4 of a head's state: walks
//   the chunks in order, 8 records loaded ahead, and overwrites each
//   chunk's increment with the state entering it; then writes sT.
// * Phase 3 (output_kernel), one block a (batch, head, chunk), warp w the
//   rows 16w..16w+15: Q K^T once for all value columns (q, k whole),
//   times D, as A fragments in PA parts; then per 64 value columns Q S
//   against the entering state (copied to shared memory by cp.async; the
//   accumulator order of dS^T is the B-operand order of S for Q S, each
//   float pair in PS parts), times gamma, plus A V, all on mma.sync.
//
// mma.sync and not wgmma: each product is at most 64 rows, A V is lower
// triangular by 16-row tiles, and the state arrives in register order
// from phase 2, so no operand needs wgmma's swizzled shared-memory tiles.
//
// Precision: A, k . kscale and the entering state are float32 and are
// taken in bf16 parts (each part the rounding of what the earlier ones
// leave; three keep all of float32's 24 bits).  The plain mirror
// (kernels/gla.py: chunk_factors, state_pass, chunk_outputs,
// emulate=True, PARTS) rounds the same way.
//
// Padding: the key dim to DKP = 64 MT (MT = 1..4, dk <= 256), the value
// dim to 16-column tiles, with zeros; S to whole chunks (rows past S are
// neutral).  Nothing here allocates or copies to the host (graph-safe).
#pragma once
#include "delta_hopper.cuh"  // mma.sync fragments, split products, tiles

namespace gla_hopper {

using delta_hopper::acc_to_a;
using delta_hopper::cp_async16;
using delta_hopper::cp_commit;
using delta_hopper::cp_wait_all;
using delta_hopper::FRAG;
using delta_hopper::load_a;
using delta_hopper::load_b_kn;
using delta_hopper::load_b_nk;
using delta_hopper::load_tile;
using delta_hopper::mma_split;
using delta_hopper::pack16;
using delta_hopper::split_pair;

constexpr int C = delta_hopper::C;    // chunk rows
constexpr int NT = delta_hopper::NT;  // threads of a phase-1/3 block (4 warps)
constexpr int NT2 = 128;              // threads of a phase-2 block
constexpr int VB = 64;                // value columns a pass
constexpr int AHEAD = 8;              // chunk records phase 2 loads ahead

// bf16 parts of each float32 operand of the tensor-core products: k .
// kscale in dS, A = Q K^T . D in A V, and the entering state in Q S.
// With A in two parts the bf16 outputs round otherwise than the float32
// plain version's in ~1.5e-3 of them (the CPU mirror at zamba2's head);
// three everywhere bring that to ~3e-5, near float32 in another order.
// test_gla_core_parts_are_the_mirrors (tests/test_torch_gpu.py) holds
// kernels/gla.py's PARTS (prfaas_gla_parts) to these.
constexpr int PK = 3, PA = 3, PS = 3;

template <int MT>
struct Layout {
  static constexpr int DKP = 64 * MT;
  static constexpr int KT = DKP / 16;  // 16-wide key tiles
  static constexpr int KN = DKP / 8;   // 8-wide key tiles of a record
  static constexpr int KS = DKP + 8;   // bf16 row stride of q and k tiles
  static constexpr int VS = VB + 8;    // bf16 row stride of a v tile
  // bytes of a 16-column tile of a record, and the record of a chunk
  static constexpr int CT_BYTES = KN * FRAG;
  __host__ __device__ static size_t record(int dv) {
    return (size_t)((dv + 15) / 16) * CT_BYTES;
  }
  // the records of B * H * ceil(S / C) chunks, then their g
  static size_t workspace(int B, int H, int S, int dv) {
    return (size_t)B * H * cdiv(S, C) * (record(dv) + sizeof(float));
  }
  // phase 1: k [row][key], its PK scaled parts, a v tile, cs, kscale
  static constexpr int P1_K = 0;
  static constexpr int P1_KP = P1_K + C * KS * 2;
  static constexpr int P1_V = P1_KP + PK * C * KS * 2;
  static constexpr int P1_VEC = P1_V + C * VS * 2;
  static constexpr int P1_SMEM = P1_VEC + 2 * C * 4;
  // phase 3: q, k [row][key], a v tile, a pass's 4 tiles of the entering
  // state, cs
  static constexpr int P3_Q = 0;
  static constexpr int P3_K = P3_Q + C * KS * 2;
  static constexpr int P3_V = P3_K + C * KS * 2;
  static constexpr int P3_S = P3_V + C * VS * 2;
  static constexpr int P3_VEC = P3_S + 4 * CT_BYTES;
  static constexpr int P3_SMEM = P3_VEC + C * 4;
};

// Warp 0: the inclusive scan of the chunk's log decays (rows at or past
// `len` take 0), two rows a lane, into cs[0..63].
__device__ __forceinline__ void scan_decays(const float* __restrict__ la,
                                            int r0, int len, float* cs,
                                            int lane) {
  const int i0 = 2 * lane;
  const float a0 = r0 + i0 < len ? la[r0 + i0] : 0.f;
  const float a1 = r0 + i0 + 1 < len ? la[r0 + i0 + 1] : 0.f;
  const float pair = a0 + a1;
  float x = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  cs[i0] = x - pair + a0;
  cs[i0 + 1] = x;
}

// ---- phase 1: each chunk's increment dS^T = V^T (K . kscale) --------------

template <bool kMasked, int MT>
__global__ void __launch_bounds__(NT)
increment_kernel(const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ log_a,
                 const int* __restrict__ lengths, char* __restrict__ ws,
                 float* __restrict__ gs, int H, int S, int dk, int dv) {
  using L = Layout<MT>;
  constexpr int KS = L::KS, VS = L::VS;
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_K);
  __nv_bfloat16* Kp = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_KP);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_V);
  float* cs = reinterpret_cast<float*>(smem + L::P1_VEC);
  float* ksc = cs + C;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, NC = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h, bhc = bh * NC + c;
  const int len = kMasked ? max(0, min(lengths[b], S)) : S;
  const int r0 = c * C;
  const int ctv = (dv + 15) / 16;
  float4* rec = reinterpret_cast<float4*>(ws + bhc * L::record(dv));

  if (w == 0) scan_decays(log_a + bh * S, r0, len, cs, lane);
  const size_t row0 = bh * S + r0;
  load_tile<__nv_bfloat16, 1, L::DKP, KS>(Ks, k + row0 * dk, len - r0, dk, 0,
                                          tid);
  __syncthreads();
  if (tid < C) ksc[tid] = expf(cs[C - 1] - cs[tid]);
  if (tid == 0) gs[bhc] = expf(cs[C - 1]);
  __syncthreads();
  // k . kscale in PK parts
  for (int e = tid; e < C * L::DKP / 2; e += NT) {
    const int i = e / (L::DKP / 2), d = 2 * (e % (L::DKP / 2));
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(Ks + i * KS + d));
    uint32_t parts[PK];
    split_pair<PK>(x.x * ksc[i], x.y * ksc[i], parts);
#pragma unroll
    for (int p = 0; p < PK; ++p)
      *reinterpret_cast<uint32_t*>(Kp + (p * C + i) * KS + d) = parts[p];
  }

  // warp w: value columns 16w.. of each pass, all keys, in groups of 64
  for (int vb = 0; 4 * vb < ctv; ++vb) {
    __syncthreads();  // Kp written; the previous pass's v tile read
    load_tile<__nv_bfloat16, 1, VB, VS>(Vs, v + row0 * dv, len - r0, dv,
                                        vb * VB, tid);
    __syncthreads();
    const int ct = 4 * vb + w;
    if (ct >= ctv) continue;
    uint32_t av[4][1][4];  // V^T fragments: columns 16w.., rows 16kt..
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const __nv_bfloat16* x = Vs + (16 * kt + 2 * t) * VS + 16 * w + g;
      av[kt][0][0] = pack16(x, x + VS);
      av[kt][0][1] = pack16(x + 8, x + VS + 8);
      av[kt][0][2] = pack16(x + 8 * VS, x + 9 * VS);
      av[kt][0][3] = pack16(x + 8 * VS + 8, x + 9 * VS + 8);
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
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t bk[PK][2];
#pragma unroll
          for (int p = 0; p < PK; ++p)
            load_b_kn(bk[p], Kp + p * C * KS, 16 * kt, 64 * grp + 8 * nt, KS,
                      g, t);
          mma_split<1, PK>(acc[nt], av[kt], bk);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        rec[(ct * L::KN + 8 * grp + nt) * 32 + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
  }
}

// ---- phase 2: the state through the chunks, elementwise -------------------

// The float4 `e` of a record holds, at lane l = e % 32 (g = l / 4, t = l %
// 4) of key tile kn and 16-column tile ct, the state cells (d, col) =
// (8 kn + 2t, 16 ct + g), (d + 1, col), (d, col + 8), (d + 1, col + 8).
template <int MT>
__global__ void __launch_bounds__(NT2)
state_kernel(char* __restrict__ ws, const float* __restrict__ gs,
             const float* __restrict__ s0, float* __restrict__ sT, int H,
             int dk, int dv, int NC) {
  using L = Layout<MT>;
  const int e = blockIdx.x * NT2 + threadIdx.x;
  const int ctv = (dv + 15) / 16;
  if (e >= ctv * L::KN * 32) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int lane = e & 31, kn = (e >> 5) % L::KN, ct = (e >> 5) / L::KN;
  const int d = 8 * kn + 2 * (lane & 3), col = 16 * ct + (lane >> 2);
  int at[4];
  float st[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dj = d + (j & 1), cj = col + (j & 2) * 4;
    at[j] = (dj < dk && cj < dv) ? dj * dv + cj : -1;
    st[j] = at[j] >= 0 ? s0[bh * dk * dv + at[j]] : 0.f;
  }
  const size_t rec4 = L::record(dv) / 16;
  float4* base = reinterpret_cast<float4*>(ws) + bh * NC * rec4 + e;
  const float* g = gs + bh * NC;
  for (int c0 = 0; c0 < NC; c0 += AHEAD) {
    float4 x[AHEAD];
    float gc[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < NC) {
        x[u] = base[(size_t)(c0 + u) * rec4];
        gc[u] = g[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < NC) {
        base[(size_t)(c0 + u) * rec4] = make_float4(st[0], st[1], st[2], st[3]);
        st[0] = fmaf(gc[u], st[0], x[u].x);
        st[1] = fmaf(gc[u], st[1], x[u].y);
        st[2] = fmaf(gc[u], st[2], x[u].z);
        st[3] = fmaf(gc[u], st[3], x[u].w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (at[j] >= 0) sT[bh * dk * dv + at[j]] = st[j];
}

// ---- phase 3: each chunk's output against the state entering it -----------

__device__ __forceinline__ void store_pair(__nv_bfloat16* o, int dv, int col,
                                           float x0, float x1) {
  if (col + 1 < dv && (dv & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < dv) o[col] = __float2bfloat16(x0);
    if (col + 1 < dv) o[col + 1] = __float2bfloat16(x1);
  }
}

template <bool kMasked, int MT>
__global__ void __launch_bounds__(NT)
output_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ log_a,
              const int* __restrict__ lengths, const char* __restrict__ ws,
              __nv_bfloat16* __restrict__ o, int H, int S, int dk, int dv) {
  using L = Layout<MT>;
  constexpr int KS = L::KS, VS = L::VS;
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::P3_Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::P3_K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::P3_V);
  char* Ss = smem + L::P3_S;
  float* cs = reinterpret_cast<float*>(smem + L::P3_VEC);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, NC = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h, bhc = bh * NC + c;
  const int len = kMasked ? max(0, min(lengths[b], S)) : S;
  const int r0 = c * C;
  const int ctv = (dv + 15) / 16;
  const char* rec = ws + bhc * L::record(dv);

  // a pass's 4 column tiles of the entering state, by cp.async
  auto fetch_state = [&](int vb) {
    const char* src = rec + (size_t)4 * vb * L::CT_BYTES;
    const int bytes = min(4, ctv - 4 * vb) * L::CT_BYTES;
    for (int off = tid * 16; off < bytes; off += NT * 16)
      cp_async16(Ss + off, src + off);
    cp_commit();
  };
  const size_t row0 = bh * S + r0;
  if (w == 0) scan_decays(log_a + bh * S, r0, len, cs, lane);
  load_tile<__nv_bfloat16, 1, L::DKP, KS>(Qs, q + row0 * dk, S - r0, dk, 0,
                                          tid);
  load_tile<__nv_bfloat16, 1, L::DKP, KS>(Ks, k + row0 * dk, len - r0, dk, 0,
                                          tid);
  __syncthreads();

  // A = Q K^T . D for rows 16w..16w+15 (column tiles past them are zero
  // and skipped), as A fragments in PA parts
  const int ia = 16 * w + g, ib = ia + 8;
  uint32_t aa[4][PA][4];
  {
    float qk[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) qk[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < L::KT; ++kt) {
      uint32_t aq[1][4];
      load_a(aq[0], Qs, 16 * w, 16 * kt, KS, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt <= 2 * w + 1) {
          uint32_t bk[1][2];
          load_b_nk(bk[0], Ks, 8 * nt, 16 * kt, KS, g, t);
          mma_split<1, 1>(qk[nt], aq, bk);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = 8 * nt + 2 * t + (e & 1);
        qk[nt][e] = j <= i ? qk[nt][e] * expf(cs[i] - cs[j]) : 0.f;
      }
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      if (kt <= w) acc_to_a<PA>(qk[2 * kt], qk[2 * kt + 1], 1.f, aa[kt]);
  }
  const float ga = expf(cs[ia]), gb = expf(cs[ib]);

  for (int vb = 0; 4 * vb < ctv; ++vb) {
    const int ncts = min(4, ctv - 4 * vb);
    __syncthreads();  // the previous pass's v tile and state read
    fetch_state(vb);
    load_tile<__nv_bfloat16, 1, VB, VS>(Vs, v + row0 * dv, len - r0, dv,
                                        vb * VB, tid);
    cp_wait_all();
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    // Q S: key tile kt's two 8-key halves of column tile ct hold the b0
    // and b1 pairs of its two 8-column n-tiles
#pragma unroll
    for (int kt = 0; kt < L::KT; ++kt) {
      uint32_t aq[1][4];
      load_a(aq[0], Qs, 16 * w, 16 * kt, KS, g, t);
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        if (ct < ncts) {
          const float4 lo = *reinterpret_cast<const float4*>(
              Ss + ct * L::CT_BYTES + (2 * kt) * FRAG + lane * 16);
          const float4 hi = *reinterpret_cast<const float4*>(
              Ss + ct * L::CT_BYTES + (2 * kt + 1) * FRAG + lane * 16);
          uint32_t b0[PS], b1[PS];
          uint32_t bs[PS][2];
          split_pair<PS>(lo.x, lo.y, b0);
          split_pair<PS>(hi.x, hi.y, b1);
#pragma unroll
          for (int p = 0; p < PS; ++p) {
            bs[p][0] = b0[p];
            bs[p][1] = b1[p];
          }
          mma_split<1, PS>(acc[2 * ct], aq, bs);
          split_pair<PS>(lo.z, lo.w, b0);
          split_pair<PS>(hi.z, hi.w, b1);
#pragma unroll
          for (int p = 0; p < PS; ++p) {
            bs[p][0] = b0[p];
            bs[p][1] = b1[p];
          }
          mma_split<1, PS>(acc[2 * ct + 1], aq, bs);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= ga;
      acc[nt][1] *= ga;
      acc[nt][2] *= gb;
      acc[nt][3] *= gb;
    }
    // + A V (A is lower triangular: row tiles 0..w)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt <= w) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < 2 * ncts) {
            uint32_t bv[1][2];
            load_b_kn(bv[0], Vs, 16 * kt, 8 * nt, VS, g, t);
            mma_split<PA, 1>(acc[nt], aa[kt], bv);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * ncts) {
        const int col = vb * VB + 8 * nt + 2 * t;
        if (r0 + ia < S)
          store_pair(o + (row0 + ia) * dv, dv, col, acc[nt][0], acc[nt][1]);
        if (r0 + ib < S)
          store_pair(o + (row0 + ib) * dv, dv, col, acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// The three phases on `stream`.  `ws` holds ws_bytes (Layout::workspace);
// returns cudaErrorInvalidValue if that is too few.
template <bool kMasked, int MT>
cudaError_t run(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const float* log_a,
                const int* lengths, const float* s0, __nv_bfloat16* o,
                float* sT, char* ws, long long ws_bytes, int B, int H, int S,
                int dk, int dv, cudaStream_t stream) {
  using L = Layout<MT>;
  const int NC = cdiv(S, C);
  if ((size_t)ws_bytes < L::workspace(B, H, S, dv)) return cudaErrorInvalidValue;
  float* gs = reinterpret_cast<float*>(ws + (size_t)B * H * NC * L::record(dv));
  cudaError_t err;
  if (NC > 0) {
    auto k1 = increment_kernel<kMasked, MT>;
    if ((err = set_smem(k1, L::P1_SMEM)) != cudaSuccess) return err;
    k1<<<dim3(NC, H, B), NT, L::P1_SMEM, stream>>>(k, v, log_a, lengths, ws,
                                                   gs, H, S, dk, dv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int cells4 = cdiv(dv, 16) * L::KN * 32;
  state_kernel<MT><<<dim3(cdiv(cells4, NT2), H, B), NT2, 0, stream>>>(
      ws, gs, s0, sT, H, dk, dv, NC);
  if ((err = cudaGetLastError()) != cudaSuccess || NC == 0) return err;
  auto k3 = output_kernel<kMasked, MT>;
  if ((err = set_smem(k3, L::P3_SMEM)) != cudaSuccess) return err;
  k3<<<dim3(NC, H, B), NT, L::P3_SMEM, stream>>>(q, k, v, log_a, lengths, ws,
                                                 o, H, S, dk, dv);
  return cudaGetLastError();
}

}  // namespace gla_hopper
