// Causal / windowed GQA flash attention with a query offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (pallas_call at flash_attn.py:119): the MLA prefill in its decompressed
// MHA form (Hq = Hkv = 64, Dk = 192, Dv = 128 at full width) and the
// chunked-prefill suffix queries over a prior cache (q_offset > 0).
//
// What bounds it on the H100: operations.  A 4096-token causal chunk does
// ~2 * 64 * 4096^2 / 2 * (192 + 128) FLOPs over a few tens of MB of Q/K/V,
// far above the card's ~295 FLOP/byte ridge.  This first version runs the
// products in float32 on the SIMT cores (no tensor cores yet), so it is
// bound by the FP32 FMA rate; wgmma on bf16 tiles is the later step.
//
// Design: one block of 256 threads owns 64 query rows of one (batch, head)
// and walks the 64-key tiles that any of its rows can see, keeping the
// running max / sum / output accumulator in registers (online softmax, as
// the TPU kernel keeps them in VMEM scratch).  Fully masked key tiles are
// never loaded: the causal bound ends the walk at the tile's last query and
// the window bound starts it at the first key still in range.  Q and K sit
// transposed in shared memory so each thread reads a float4 of 4 queries
// and a float4 of 4 keys per depth step and updates a 4x4 score tile; the
// P.V product gives each thread 4 rows x ceil(Dv/16) output columns.
// Heavier (later) causal query tiles are scheduled first.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // threads per block (16 x 16)
constexpr int QS = BQ + 4;     // row stride of transposed Q (float4-aligned)
constexpr int KS = BK + 4;     // row stride of transposed K
constexpr int PS = BK + 1;     // row stride of the probability tile

template <typename T, int DVT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Sk, int Dk, int Dv, int q_offset, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;               // [Dk][QS], pre-scaled
  float* Kt = Qt + Dk * QS;       // [Dk][KS]
  float* Vs = Kt + Dk * KS;       // [BK][Dv]
  float* Ps = Vs + BK * Dv;       // [BQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qtile * BQ;
  const T* qp = q + (size_t)(b * Hq + h) * Sq * Dk;
  const T* kp = k + (size_t)(b * Hkv + hk) * Sk * Dk;
  const T* vp = v + (size_t)(b * Hkv + hk) * Sk * Dv;
  T* op = o + (size_t)(b * Hq + h) * Sq * Dv;

  for (int idx = tid; idx < BQ * Dk; idx += NT) {
    const int i = idx / Dk, d = idx - i * Dk;
    Qt[d * QS + i] =
        (q0 + i < Sq) ? to_f32(qp[(size_t)(q0 + i) * Dk + d]) * scale : 0.f;
  }

  // keys any row of this tile can see; tiles outside are skipped
  const int q_first = q_offset + q0, q_last = q_first + BQ - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DVT; ++cc) acc[r][cc] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * Dk; idx += NT) {
      const int j = idx / Dk, d = idx - j * Dk;
      Kt[d * KS + j] =
          (k0 + j < Sk) ? to_f32(kp[(size_t)(k0 + j) * Dk + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int j = idx / Dv, c = idx - j * Dv;
      Vs[idx] = (k0 + j < Sk) ? to_f32(vp[(size_t)(k0 + j) * Dv + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * KS + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_first + ty * 4 + r;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[r][c] = ok ? s[r][c] : -INFINITY;
        rmax = fmaxf(rmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m[r] == -INFINITY) ? 0.f : expf(m[r] - safe);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (s[r][c] == -INFINITY) ? 0.f : expf(s[r][c] - safe);
        Ps[(ty * 4 + r) * PS + tx * 4 + c] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = corr * l[r] + rsum;
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < DVT; ++cc) acc[r][cc] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vv[DVT];
#pragma unroll
      for (int cc = 0; cc < DVT; ++cc) {
        const int c = tx + 16 * cc;
        vv[cc] = (c < Dv) ? Vs[j * Dv + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty * 4 + r) * PS + j];
#pragma unroll
        for (int cc = 0; cc < DVT; ++cc) acc[r][cc] = fmaf(p, vv[cc], acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Sq) continue;
    // a row that saw no key (l == 0) writes 0, as the TPU kernel does
#pragma unroll
    for (int cc = 0; cc < DVT; ++cc) {
      const int c = tx + 16 * cc;
      if (c < Dv)
        op[(size_t)i * Dv + c] =
            from_f32<T>(l[r] == 0.f ? 0.f : acc[r][cc] / l[r]);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Sk, int Dk, int Dv,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(Dk * QS + Dk * KS + BK * Dv + BQ * PS) * sizeof(float);
  auto kernel = flash_kernel<T, DVT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(Sq, BQ), Hq, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, Dk, Dv,
      q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int Dk, int Dv,
                     int q_offset, int causal, int window, float scale,
                     cudaStream_t s) {
  const int need = cdiv(Dv, 16);
  if (need <= 1)
    return launch<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                        causal, window, scale, s);
  if (need <= 2)
    return launch<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                        causal, window, scale, s);
  if (need <= 4)
    return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                        causal, window, scale, s);
  if (need <= 8)
    return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                        causal, window, scale, s);
  if (need <= 16)
    return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                         causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,Hq,Sq,Dk), k (B,Hkv,Sk,Dk), v (B,Hkv,Sk,Dv) -> o (B,Hq,Sq,Dv),
// all contiguous and of one dtype (kF32 or kBF16).
PRFAAS_API int prfaas_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int Dk, int Dv,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv,
                                   q_offset, causal, window, scale, s);
  if (dtype == kF32)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                           causal, window, scale, s);
  return cudaErrorInvalidValue;
}
