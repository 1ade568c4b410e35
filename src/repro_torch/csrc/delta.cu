// Chunked gated delta rule, in two instances of one template:
//
//   * kMasked = true replaces the TPU kernel
//     src/repro/kernels/delta.py::delta_chunked_fused (pallas_call at
//     delta.py:218): the KDA prefill over right-padded rows, H = 56 heads
//     with dk = dv = 128 at full width, bf16 q/k/v, float32 decays, write
//     strengths and state;
//   * kMasked = false replaces src/repro/kernels/delta.py::delta_chunked
//     (pallas_call at delta.py:155): the same rule with every row valid,
//     the forward of training and unpadded evaluation of KDA / GDN mixers.
//     It reads no lengths.
//
//     S_t = a_t (I - beta_t k_t k_t^T) S_{t-1} + beta_t k_t v_t^T
//     o_t = q_t S_t
//
// Rows at or past lengths[b] (masked instance) and the tail chunk's rows
// past S (both) are neutralized in-kernel (decay -> 1, k -> 0, beta -> 0),
// so the returned state is the state after each row's real tokens,
// whatever bucket padding follows.
//
// What bounds it on the H100: the recurrence.  Per 64-token chunk the work
// is a handful of 64x128 and 64x64 products (a few MFLOP) over 64 rows of
// q/k/v, so the arithmetic intensity is high, but the chunks of one head
// must run in order.  This first version runs the products in float32 on
// the SIMT cores, so it is bound by the FP32 FMA rate of the blocks in
// flight.
//
// Design: the TPU kernel's sequential grid over chunks becomes a loop over
// chunks inside one block, with the float32 state held in shared memory.
// The columns of the state (the dv axis) evolve independently under this
// recurrence, so each block owns 32 state columns of one (batch, head):
// 4x more blocks than (batch, head) pairs and a 16 KB state slice instead
// of the whole 64 KB.  Within a chunk the WY form needs (I + N)^-1 applied
// to a 64 x 32 right-hand side, N strictly lower triangular; the TPU kernel
// builds the inverse from log2(64) dense products (a Neumann product, which
// suits its matrix unit), while this kernel solves by forward substitution,
// one row per step, 32 columns x 8 row groups in parallel.
#include "common.cuh"

namespace {

constexpr int C = 64;      // chunk length
constexpr int DVB = 32;    // state columns per block
constexpr int NT = 256;    // threads per block (8 warps)
constexpr int CS = C + 1;  // row stride of the C x C matrices

template <typename T, bool kMasked>
__global__ void __launch_bounds__(NT)
delta_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ log_a,
                   const float* __restrict__ beta,
                   const int* __restrict__ lengths,
                   const float* __restrict__ s0, T* __restrict__ o,
                   float* __restrict__ sT, int H, int S, int dk, int dv) {
  extern __shared__ float smem[];
  const int KS = dk + 1;             // odd stride: conflict-free row reads
  float* qs = smem;                  // [C][KS]
  float* ks = qs + C * KS;           // [C][KS]
  float* Ss = ks + C * KS;           // [dk][DVB] state slice
  float* Us = Ss + dk * DVB;         // [C][DVB]  v -> rhs -> u
  float* Am = Us + C * DVB;          // [C][CS]   diag(beta) (K K^T . decay), strict
  float* Qm = Am + C * CS;           // [C][CS]   Q K^T . decay, inclusive
  float* cs = Qm + C * CS;           // [C] cumulative log decay
  float* bt = cs + C;                // [C] masked beta
  float* ksc = bt + C;               // [C] exp(cs[C-1] - cs[i])

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
  const float* bp = beta + bh * S;
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
      Us[idx] = (row < S && c < ncol) ? to_f32(vp[(size_t)row * dv + c0 + c]) : 0.f;
    }
    if (warp == 0) {
      // inclusive scan of the chunk's log decays, two rows per lane
      const int i0 = 2 * lane;
      const float a0 = (t0 + i0 < len) ? lap[t0 + i0] : 0.f;
      const float a1 = (t0 + i0 + 1 < len) ? lap[t0 + i0 + 1] : 0.f;
      const float pair = a0 + a1;
      float x = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      const float before = x - pair;
      cs[i0] = before + a0;
      cs[i0 + 1] = x;
      bt[i0] = (t0 + i0 < len) ? bp[t0 + i0] : 0.f;
      bt[i0 + 1] = (t0 + i0 + 1 < len) ? bp[t0 + i0 + 1] : 0.f;
    }
    __syncthreads();
    if (tid < C) ksc[tid] = expf(cs[C - 1] - cs[tid]);

    {  // Am, Qm: rows ty*4 + r, columns tx + 16 c
      float kk[4][4], qk[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) kk[r][c] = qk[r][c] = 0.f;
      for (int d = 0; d < dk; ++d) {
        float ki[4], qi[4], kj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ki[r] = ks[(ty * 4 + r) * KS + d];
          qi[r] = qs[(ty * 4 + r) * KS + d];
          kj[r] = ks[(tx + 16 * r) * KS + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            kk[r][c] = fmaf(ki[r], kj[c], kk[r][c]);
            qk[r][c] = fmaf(qi[r], kj[c], qk[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty * 4 + r, j = tx + 16 * c;
          const float e = (j <= i) ? expf(cs[i] - cs[j]) : 0.f;
          Am[i * CS + j] = (j < i) ? bt[i] * (kk[r][c] * e) : 0.f;
          Qm[i * CS + j] = (j <= i) ? qk[r][c] * e : 0.f;
        }
    }

    // against the incoming state: rhs = beta (v - (k gamma) S), o1 = (q gamma) S
    float o1[C / 8];
#pragma unroll
    for (int r = 0; r < C / 8; ++r) {
      const int i = warp + 8 * r;
      float kS = 0.f, qS = 0.f;
      for (int d = 0; d < dk; ++d) {
        const float sv = Ss[d * DVB + lane];
        kS = fmaf(ks[i * KS + d], sv, kS);
        qS = fmaf(qs[i * KS + d], sv, qS);
      }
      const float g = expf(cs[i]);
      o1[r] = g * qS;
      Us[i * DVB + lane] = bt[i] * (Us[i * DVB + lane] - g * kS);
    }
    __syncthreads();

    // u = (I + Am)^-1 rhs by forward substitution
    for (int j = 0; j < C - 1; ++j) {
      const float uj = Us[j * DVB + lane];
#pragma unroll
      for (int r = 0; r < C / 8; ++r) {
        const int i = warp + 8 * r;
        if (i > j) Us[i * DVB + lane] -= Am[i * CS + j] * uj;
      }
      __syncthreads();
    }

    // o = o1 + (Q K^T . decay) u ;  S = g_C S + (k . kscale)^T u
#pragma unroll
    for (int r = 0; r < C / 8; ++r) {
      const int i = warp + 8 * r, row = t0 + i;
      float a = o1[r];
      for (int j = 0; j <= i; ++j) a = fmaf(Qm[i * CS + j], Us[j * DVB + lane], a);
      if (row < S && lane < ncol) op[(size_t)row * dv + c0 + lane] = from_f32<T>(a);
    }
    const float gC = expf(cs[C - 1]);
    for (int d = warp; d < dk; d += 8) {
      float a = 0.f;
      for (int i = 0; i < C; ++i)
        a = fmaf(ks[i * KS + d] * ksc[i], Us[i * DVB + lane], a);
      Ss[d * DVB + lane] = gC * Ss[d * DVB + lane] + a;
    }
  }

  for (int d = warp; d < dk; d += 8)
    if (lane < ncol) sT[(bh * dk + d) * dv + c0 + lane] = Ss[d * DVB + lane];
}

template <typename T, bool kMasked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_a, const float* beta, const int* lengths,
                   const float* s0, void* o, float* sT, int B, int H, int S,
                   int dk, int dv, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * C * (dk + 1) + dk * DVB + C * DVB +
                               2 * C * CS + 3 * C) * sizeof(float);
  auto kernel = delta_kernel<T, kMasked>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(dv, DVB), H, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_a, beta, lengths, s0, static_cast<T*>(o),
      sT, H, S, dk, dv);
  return cudaGetLastError();
}

template <bool kMasked>
int dispatch(const void* q, const void* k, const void* v, const void* log_a,
             const void* beta, const void* lengths, const void* s0, void* o,
             void* sT, int B, int H, int S, int dk, int dv, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bt = static_cast<const float*>(beta);
  const int* lens = static_cast<const int*>(lengths);
  const float* st0 = static_cast<const float*>(s0);
  float* stT = static_cast<float*>(sT);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kMasked>(q, k, v, la, bt, lens, st0, o, stT,
                                          B, H, S, dk, dv, s);
  if (dtype == kF32)
    return launch<float, kMasked>(q, k, v, la, bt, lens, st0, o, stT, B, H,
                                  S, dk, dv, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k (B,H,S,dk), v (B,H,S,dv) of one dtype; log_a, beta (B,H,S) float32;
// lengths (B,) int32; s0 (B,H,dk,dv) float32 -> o (B,H,S,dv) in q's dtype,
// sT (B,H,dk,dv) float32.
PRFAAS_API int prfaas_delta_fused(const void* q, const void* k, const void* v,
                                  const void* log_a, const void* beta,
                                  const void* lengths, const void* s0,
                                  void* o, void* sT, int B, int H, int S,
                                  int dk, int dv, int dtype, void* stream) {
  return dispatch<true>(q, k, v, log_a, beta, lengths, s0, o, sT, B, H, S,
                        dk, dv, dtype, stream);
}

// The same without lengths: every row of every batch row is valid.
PRFAAS_API int prfaas_delta_chunked(const void* q, const void* k,
                                    const void* v, const void* log_a,
                                    const void* beta, const void* s0, void* o,
                                    void* sT, int B, int H, int S, int dk,
                                    int dv, int dtype, void* stream) {
  return dispatch<false>(q, k, v, log_a, beta, nullptr, s0, o, sT, B, H, S,
                         dk, dv, dtype, stream);
}
