// Chunked gated linear attention (scalar per-head decay), in two
// instances of one template:
//
//   * kMasked = true replaces the TPU kernel
//     src/repro/kernels/gla.py::gla_chunked_fused (pallas_call at
//     gla.py:185): every serving prefill of a Mamba2 mixer (zamba2-1.2b:
//     H = 32 heads, dk = 64, dv = 128, bf16 q/k/v, float32 decays and
//     state) over right-padded rows, and later of GLA and mLSTM;
//   * kMasked = false replaces src/repro/kernels/gla.py::gla_chunked
//     (pallas_call at gla.py:126): the same scan with every row valid, the
//     forward of training and unpadded evaluation.  It reads no lengths.
//
//     S_t = exp(log_a_t) S_{t-1} + k_t v_t^T ,   o_t = q_t S_t
//
// in chunks of C = 64 rows, in the TPU kernel's chunk form: with csum the
// inclusive cumulative sum of log_a within the chunk,
//     A[t,s] = (q_t . k_s) exp(csum_t - csum_s)  for s <= t, else 0
//     o      = A v + (q . exp(csum)) S
//     S     <- exp(csum_C) S + (k . exp(csum_C - csum))^T v
// so every exponent is <= 0 and no 1/gamma appears.  Rows at or past
// lengths[b] (masked instance) and the tail chunk's rows past S (both) are
// neutralized by selection (k -> 0, v -> 0, log_a -> 0): garbage there, NaN
// included, never reaches the state.  Output rows past a length are
// unspecified, as in the TPU kernel.
//
// bf16 inputs run the three-phase Hopper core of gla_hopper.cuh (the
// products of all chunks at once on the tensor cores around an
// elementwise state pass), dispatched here on the key dim padded to 64,
// 128, 192 or 256.  float32 inputs run the SIMT kernel below.
//
// The float32 kernel: the TPU kernel's sequential grid over chunks becomes
// a loop over chunks inside one block, with the float32 state held in
// shared memory.  Column j of the state depends only on v[:, j], so each
// block owns DVB = 32 state columns of one (batch, head).  A partial last
// slice (dv not a multiple of 32, as mLSTM's dv = 257) has its idle lanes
// compute on zeros and store nothing.  Its products run in float32 on the
// SIMT cores, bound by their FMA rate and by the chunks of a head running
// in order.
#include "gla_hopper.cuh"

namespace {

constexpr int C = 64;      // chunk length
constexpr int DVB = 32;    // state columns per block
constexpr int NT = 256;    // threads per block (8 warps)
constexpr int CS = C + 1;  // row stride of the C x C matrix

template <typename T, bool kMasked>
__global__ void __launch_bounds__(NT)
gla_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ log_a,
                 const int* __restrict__ lengths,
                 const float* __restrict__ s0, T* __restrict__ o,
                 float* __restrict__ sT, int H, int S, int dk, int dv) {
  extern __shared__ float smem[];
  const int KS = dk + 1;             // odd stride: conflict-free row reads
  float* qs = smem;                  // [C][KS]
  float* ks = qs + C * KS;           // [C][KS]
  float* Ss = ks + C * KS;           // [dk][DVB] state slice
  float* Vs = Ss + dk * DVB;         // [C][DVB]  value slice
  float* Am = Vs + C * DVB;          // [C][CS]   Q K^T . decay, inclusive
  float* la = Am + C * CS;           // [C] masked log decays
  float* cs = la + C;                // [C] cumulative log decay
  float* gm = cs + C;                // [C] exp(cs[i])
  float* ksc = gm + C;               // [C] exp(cs[C-1] - cs[i])

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * DVB, h = blockIdx.y, b = blockIdx.z;
  const int ncol = min(DVB, dv - c0);
  const size_t bh = (size_t)b * H + h;
  const int len = kMasked ? min(lengths[b], S) : S;
  const T* qp = q + bh * S * dk;
  const T* kp = k + bh * S * dk;
  const T* vp = v + bh * S * dv;
  const float* lap = log_a + bh * S;
  T* op = o + bh * S * dv;

  // thread (warp, lane) owns state cells (d = warp + 8 r, lane)
  for (int d = warp; d < dk; d += 8)
    Ss[d * DVB + lane] = lane < ncol ? s0[(bh * dk + d) * dv + c0 + lane] : 0.f;

  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();
    for (int idx = tid; idx < C * dk; idx += NT) {
      const int i = idx / dk, d = idx - i * dk, row = t0 + i;
      qs[i * KS + d] = row < S ? to_f32(qp[(size_t)row * dk + d]) : 0.f;
      ks[i * KS + d] = row < len ? to_f32(kp[(size_t)row * dk + d]) : 0.f;
    }
    for (int idx = tid; idx < C * DVB; idx += NT) {
      const int i = idx / DVB, c = idx - i * DVB, row = t0 + i;
      Vs[idx] = (row < len && c < ncol) ? to_f32(vp[(size_t)row * dv + c0 + c])
                                        : 0.f;
    }
    if (tid < C) la[tid] = (t0 + tid < len) ? lap[t0 + tid] : 0.f;
    __syncthreads();
    if (tid < C) {
      float x = 0.f;
      for (int j = 0; j <= tid; ++j) x += la[j];
      cs[tid] = x;
    }
    __syncthreads();
    if (tid < C) {
      gm[tid] = expf(cs[tid]);
      ksc[tid] = expf(cs[C - 1] - cs[tid]);
    }

    {  // Am: rows ty*4 + r, columns tx + 16 c
      float qk[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) qk[r][c] = 0.f;
      for (int d = 0; d < dk; ++d) {
        float qi[4], kj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qi[r] = qs[(ty * 4 + r) * KS + d];
          kj[r] = ks[(tx + 16 * r) * KS + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) qk[r][c] = fmaf(qi[r], kj[c], qk[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty * 4 + r, j = tx + 16 * c;
          Am[i * CS + j] = (j <= i) ? qk[r][c] * expf(cs[i] - cs[j]) : 0.f;
        }
    }
    __syncthreads();

    // o = A v + gamma (q S), against the incoming state
#pragma unroll
    for (int r = 0; r < C / 8; ++r) {
      const int i = warp + 8 * r, row = t0 + i;
      float qS = 0.f;
      for (int d = 0; d < dk; ++d) qS = fmaf(qs[i * KS + d], Ss[d * DVB + lane], qS);
      float a = 0.f;
      for (int j = 0; j <= i; ++j) a = fmaf(Am[i * CS + j], Vs[j * DVB + lane], a);
      a = fmaf(gm[i], qS, a);
      if (row < S && lane < ncol) op[(size_t)row * dv + c0 + lane] = from_f32<T>(a);
    }
    __syncthreads();

    // S = g_C S + (k . kscale)^T v
    const float gC = expf(cs[C - 1]);
    for (int d = warp; d < dk; d += 8) {
      float a = 0.f;
      for (int i = 0; i < C; ++i)
        a = fmaf(ks[i * KS + d] * ksc[i], Vs[i * DVB + lane], a);
      Ss[d * DVB + lane] = gC * Ss[d * DVB + lane] + a;
    }
  }

  for (int d = warp; d < dk; d += 8)
    if (lane < ncol) sT[(bh * dk + d) * dv + c0 + lane] = Ss[d * DVB + lane];
}

template <typename T, bool kMasked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_a, const int* lengths, const float* s0,
                   void* o, float* sT, int B, int H, int S, int dk, int dv,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * C * (dk + 1) + dk * DVB + C * DVB +
                               C * CS + 4 * C) * sizeof(float);
  auto kernel = gla_kernel<T, kMasked>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(dv, DVB), H, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_a, lengths, s0, static_cast<T*>(o), sT,
      H, S, dk, dv);
  return cudaGetLastError();
}

template <bool kMasked>
cudaError_t by_width(const void* q, const void* k, const void* v,
                     const float* log_a, const int* lengths, const float* s0,
                     void* o, float* sT, char* ws, long long ws_bytes, int B,
                     int H, int S, int dk, int dv, cudaStream_t stream) {
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* oo = static_cast<__nv_bfloat16*>(o);
  switch (cdiv(dk, 64)) {
#define PRFAAS_GLA_MT(mt)                                                   \
  case mt:                                                                  \
    return gla_hopper::run<kMasked, mt>(qq, kk, vv, log_a, lengths, s0, oo, \
                                        sT, ws, ws_bytes, B, H, S, dk, dv,  \
                                        stream);
    PRFAAS_GLA_MT(1)
    PRFAAS_GLA_MT(2)
    PRFAAS_GLA_MT(3)
    PRFAAS_GLA_MT(4)
#undef PRFAAS_GLA_MT
  }
  return cudaErrorInvalidValue;  // dk outside 1..256
}

template <bool kMasked>
int dispatch(const void* q, const void* k, const void* v, const void* log_a,
             const void* lengths, const void* s0, void* o, void* sT, void* ws,
             long long ws_bytes, int B, int H, int S, int dk, int dv,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const int* lens = static_cast<const int*>(lengths);
  const float* st0 = static_cast<const float*>(s0);
  float* stT = static_cast<float*>(sT);
  if (dtype == kBF16)
    return by_width<kMasked>(q, k, v, la, lens, st0, o, stT,
                             static_cast<char*>(ws), ws_bytes, B, H, S, dk,
                             dv, s);
  if (dtype == kF32)
    return launch<float, kMasked>(q, k, v, la, lens, st0, o, stT, B, H, S,
                                  dk, dv, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the workspace both entry points need at these shapes (0 for
// float32, which needs none), or -1 for a dtype or key dim they refuse.
PRFAAS_API long long prfaas_gla_workspace_bytes(int B, int H, int S, int dk,
                                                int dv, int dtype) {
  if (dtype == kF32) return 0;
  if (dtype != kBF16) return -1;
  switch (cdiv(dk, 64)) {
    case 1: return gla_hopper::Layout<1>::workspace(B, H, S, dv);
    case 2: return gla_hopper::Layout<2>::workspace(B, H, S, dv);
    case 3: return gla_hopper::Layout<3>::workspace(B, H, S, dv);
    case 4: return gla_hopper::Layout<4>::workspace(B, H, S, dv);
  }
  return -1;
}

// The bf16 parts of the core's float32 operands, in the order k . kscale,
// A, S (kernels/gla.py's PARTS mirrors them).
PRFAAS_API void prfaas_gla_parts(int* parts) {
  parts[0] = gla_hopper::PK;
  parts[1] = gla_hopper::PA;
  parts[2] = gla_hopper::PS;
}

// q, k (B,H,S,dk), v (B,H,S,dv) of one dtype; log_a (B,H,S) float32;
// lengths (B,) int32; s0 (B,H,dk,dv) float32; ws a workspace of ws_bytes
// (prfaas_gla_workspace_bytes) -> o (B,H,S,dv) in q's dtype, sT
// (B,H,dk,dv) float32.
PRFAAS_API int prfaas_gla_fused(const void* q, const void* k, const void* v,
                                const void* log_a, const void* lengths,
                                const void* s0, void* o, void* sT, void* ws,
                                long long ws_bytes, int B, int H, int S,
                                int dk, int dv, int dtype, void* stream) {
  return dispatch<true>(q, k, v, log_a, lengths, s0, o, sT, ws, ws_bytes, B,
                        H, S, dk, dv, dtype, stream);
}

// The same without lengths: every row of every batch row is valid.
PRFAAS_API int prfaas_gla_chunked(const void* q, const void* k, const void* v,
                                  const void* log_a, const void* s0, void* o,
                                  void* sT, void* ws, long long ws_bytes,
                                  int B, int H, int S, int dk, int dv,
                                  int dtype, void* stream) {
  return dispatch<false>(q, k, v, log_a, nullptr, s0, o, sT, ws, ws_bytes, B,
                         H, S, dk, dv, dtype, stream);
}
