// One-query flash-decode over a dense per-slot cache, with per-row lengths
// and a sliding-window mask.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py::decode_attention
// (pallas_call at decode_attn.py:94).  On the main path it is the absorbed
// MLA decode: MQA over the latent cache, Hq = 64 query heads against
// Hkv = 1 cache head, Dk = 472 + 64 = 536 (k = [ckv, kpe]) and Dv = 472
// (v = ckv), bf16.
//
// What bounds it on the H100: bytes.  Each key costs (Dk + Dv) * 2 bytes and
// 2 * (Dk + Dv) FLOPs per query head, so even with all 64 heads sharing a
// key the kernel sits near 64 FLOP/byte, under the ~295 ridge: the cache
// has to stream from HBM once, and the time is that stream.
//
// Design: a block owns G query heads that share one cache head (G = 16 on
// the main path) and one split of the key axis.  It loads each 16-key tile
// of K and V once into shared memory and scores it against all G heads, so
// the cache is read Hq / G = 4 times (through L2) rather than 64 times as a
// block per (row, head) would.  Splitting the key axis (flash-decoding)
// gives enough blocks to fill the SMs (about two blocks each; the wrapper
// reads the count from the device) when there are few slots and long
// caches; a second small kernel merges the splits' (max, sum, accumulator)
// triples.  Keys at or past lengths[b], or before lengths[b] - window, are
// masked; a split with no live key contributes nothing.
#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int BK = 16;      // keys per tile
constexpr int MAXO = 32;    // accumulator registers per thread (G*Dv <= 8192)

template <typename T>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int Hq, int Hkv, int S, int Dk, int Dv, int G, int window,
               float scale, int split_len) {
  extern __shared__ float smem[];
  const int KS = Dk | 1;               // odd stride: conflict-free key rows
  float* qs = smem;                    // [G][Dk], pre-scaled
  float* ks = qs + G * Dk;             // [BK][KS]
  float* vs = ks + BK * KS;            // [BK][Dv]
  float* ps = vs + BK * Dv;            // [G][BK]
  float* st_m = ps + G * BK;           // running max per head
  float* st_l = st_m + G;              // running sum per head
  float* st_c = st_l + G;              // this tile's rescale per head

  const int tid = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x;
  const int h0 = blockIdx.y * G, b = blockIdx.z;
  const int hk = h0 / (Hq / Hkv);
  const int len = min(lengths[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int start = max(split * split_len, lo);
  const int stop = min(min(S, split * split_len + split_len), len);

  const T* qp = q + (size_t)(b * Hq + h0) * Dk;
  for (int idx = tid; idx < G * Dk; idx += NT) qs[idx] = to_f32(qp[idx]) * scale;
  if (tid < G) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }
  const T* kp = k + (size_t)(b * Hkv + hk) * S * Dk;
  const T* vp = v + (size_t)(b * Hkv + hk) * S * Dv;

  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;

  for (int j0 = start; j0 < stop; j0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * Dk; idx += NT) {
      const int j = idx / Dk, d = idx - j * Dk;
      ks[j * KS + d] = (j0 + j < stop) ? to_f32(kp[(size_t)(j0 + j) * Dk + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int j = idx / Dv, c = idx - j * Dv;
      vs[idx] = (j0 + j < stop) ? to_f32(vp[(size_t)(j0 + j) * Dv + c]) : 0.f;
    }
    __syncthreads();
    if (tid < G * BK) {
      const int hh = tid / BK, jj = tid - hh * BK;
      const float* qh = qs + hh * Dk;
      const float* kj = ks + jj * KS;
      float s = 0.f;
      for (int d = 0; d < Dk; ++d) s = fmaf(qh[d], kj[d], s);
      ps[tid] = (j0 + jj < stop) ? s : -INFINITY;
    }
    __syncthreads();
    if (tid < G) {
      float* p = ps + tid * BK;
      float mt = -INFINITY;
      for (int jj = 0; jj < BK; ++jj) mt = fmaxf(mt, p[jj]);
      const float m_old = st_m[tid];
      const float m_new = fmaxf(m_old, mt);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - safe);
      float sum = 0.f;
      for (int jj = 0; jj < BK; ++jj) {
        const float e = (p[jj] == -INFINITY) ? 0.f : expf(p[jj] - safe);
        p[jj] = e;
        sum += e;
      }
      st_m[tid] = m_new;
      st_l[tid] = corr * st_l[tid] + sum;
      st_c[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int o = tid + NT * i;
      if (o < G * Dv) {
        const int hh = o / Dv, c = o - hh * Dv;
        const float* p = ps + hh * BK;
        float a = acc[i] * st_c[hh];
        for (int jj = 0; jj < BK; ++jj) a = fmaf(p[jj], vs[jj * Dv + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  const size_t row0 = (size_t)(b * Hq + h0) * splits + split;  // head h0
  if (tid < G) {
    part_ml[(row0 + (size_t)tid * splits) * 2] = st_m[tid];
    part_ml[(row0 + (size_t)tid * splits) * 2 + 1] = st_l[tid];
  }
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = tid + NT * i;
    if (o < G * Dv) {
      const int hh = o / Dv, c = o - hh * Dv;
      part_acc[(row0 + (size_t)hh * splits) * Dv + c] = acc[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out, int Hq,
               int Dv, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row0 = (size_t)(b * Hq + h) * splits;
  float mt = -INFINITY;
  for (int s = 0; s < splits; ++s) mt = fmaxf(mt, part_ml[(row0 + s) * 2]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float m = part_ml[(row0 + s) * 2];
    if (m != -INFINITY) den += expf(m - mt) * part_ml[(row0 + s) * 2 + 1];
  }
  for (int c = threadIdx.x; c < Dv; c += NT) {
    float num = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float m = part_ml[(row0 + s) * 2];
      if (m != -INFINITY) num += expf(m - mt) * part_acc[(row0 + s) * Dv + c];
    }
    // a row with no live key (den == 0) writes 0, as the TPU kernel does
    out[((size_t)b * Hq + h) * Dv + c] = from_f32<T>(den == 0.f ? 0.f : num / den);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int B, int Hq, int Hkv, int S, int Dk,
                   int Dv, int G, int window, float scale, int splits,
                   int split_len, cudaStream_t stream) {
  if (G * BK > NT || G * Dv > NT * MAXO || (Hq / Hkv) % G != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(G * Dk + BK * (Dk | 1) + BK * Dv + G * BK + 3 * G) *
      sizeof(float);
  auto kernel = decode_partial<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, Hq / G, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, Hq, Hkv, S, Dk,
      Dv, G, window, scale, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(Hq, B), NT, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Hq, Dv, splits);
  return cudaGetLastError();
}

}  // namespace

// q (B,Hq,Dk), k (B,Hkv,S,Dk), v (B,Hkv,S,Dv), lengths (B,) int32
// -> out (B,Hq,Dv).  part_acc (B,Hq,splits,Dv) and part_ml (B,Hq,splits,2)
// are float32 scratch the caller allocates.
PRFAAS_API int prfaas_decode_attention(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part_acc,
                                       void* part_ml, int B, int Hq, int Hkv,
                                       int S, int Dk, int Dv, int G,
                                       int window, float scale, int splits,
                                       int split_len, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, lens, out, pa, pm, B, Hq, Hkv, S,
                                 Dk, Dv, G, window, scale, splits, split_len,
                                 s);
  if (dtype == kF32)
    return launch<float>(q, k, v, lens, out, pa, pm, B, Hq, Hkv, S, Dk, Dv,
                         G, window, scale, splits, split_len, s);
  return cudaErrorInvalidValue;
}
