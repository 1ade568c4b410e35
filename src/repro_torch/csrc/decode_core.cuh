// One-query flash-decode shared by the dense and the paged decode kernels.
//
// A block owns G query heads that share one cache head and one split of
// the key axis.  It loads each 16-key tile of K and V once into shared
// memory and scores it against all G heads, so the cache is read Hq / G
// times (through L2) rather than once per head.  Splitting the key axis
// (flash-decoding) gives enough blocks to fill the SMs when there are few
// slots and long caches: each row's live keys are cut into `splits` equal
// runs of whole tiles, so short rows in long buffers do not leave blocks
// idle; a second small kernel merges the splits' (max, sum, accumulator)
// triples.  Keys at or past lengths[b], or before
// lengths[b] - window, are never loaded: the walk stops at the length, and
// the rows of a partly live tile are filled by selection (0, score -inf),
// never by multiplying, so garbage past the length (NaN included) cannot
// reach the sums.  A split with no live key contributes nothing.
//
// Where a key row lives is the policy `Keys`: `keys.row(b, hk, j)` is the
// index of key j of (row b, cache head hk) in units of one key row, the
// same for K (Dk wide) and V (Dv wide); `keys.S` is the number of key
// positions per row.  A policy whose rows take a lookup (`kIndirect`, a
// page table) has the first BK threads resolve each tile's rows into
// shared memory one tile ahead; a dense one computes each index in place.
#pragma once
#include "common.cuh"

namespace decode_core {

constexpr int NT = 256;     // threads per block
constexpr int BK = 16;      // keys per tile
constexpr int MAXO = 32;    // accumulator registers per thread (G*Dv <= 8192)
constexpr int RT = NT / BK; // threads loading one key row of a tile

template <typename T, typename Keys>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               Keys keys, int Hq, int Hkv, int Dk, int Dv, int G, int window,
               float scale) {
  extern __shared__ float smem[];
  __shared__ size_t rows[2][BK];       // key-row index of each tile row
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
  // this row's live keys [lo, len) in `splits` runs of whole tiles: the
  // blocks share each row's work whatever its length against S
  const int len = min(lengths[b], keys.S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int per = (max(len - lo, 0) + splits * BK - 1) / (splits * BK) * BK;
  const int start = lo + split * per;
  const int stop = min(len, start + per);

  const T* qp = q + (size_t)(b * Hq + h0) * Dk;
  for (int idx = tid; idx < G * Dk; idx += NT) qs[idx] = to_f32(qp[idx]) * scale;
  if (tid < G) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }

  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;

  // an indirect policy resolves the first tile's rows here and each next
  // tile's rows while the current one is scored (double-buffered), so the
  // lookup's latency hides behind the tile's work
  if constexpr (Keys::kIndirect) {
    if (tid < BK && start < stop)
      rows[0][tid] = (start + tid < stop) ? keys.row(b, hk, start + tid) : 0;
  }
  int buf = 0;
  for (int j0 = start; j0 < stop; j0 += BK, buf ^= 1) {
    __syncthreads();
    size_t next = 0;
    if constexpr (Keys::kIndirect) {
      if (tid < BK && j0 + BK + tid < stop) next = keys.row(b, hk, j0 + BK + tid);
    }
    {
      // RT threads per key row: one row lookup per thread and tile, and
      // consecutive threads on consecutive elements of the row
      const int j = tid / RT, lane = tid - j * RT;
      const bool live = j0 + j < stop;
      const size_t r = !live ? 0
                       : Keys::kIndirect ? rows[buf][j]
                                         : keys.row(b, hk, j0 + j);
      const T* kr = k + r * Dk;
      const T* vr = v + r * Dv;
      for (int d = lane; d < Dk; d += RT)
        ks[j * KS + d] = live ? to_f32(kr[d]) : 0.f;
      for (int c = lane; c < Dv; c += RT)
        vs[j * Dv + c] = live ? to_f32(vr[c]) : 0.f;
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
    if constexpr (Keys::kIndirect) {
      if (tid < BK) rows[buf ^ 1][tid] = next;
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

// q (B,Hq,Dk) -> out (B,Hq,Dv); part_acc (B,Hq,splits,Dv) and part_ml
// (B,Hq,splits,2) are float32 scratch the caller allocates.
template <typename T, typename Keys>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, Keys keys, int B, int Hq, int Hkv, int Dk,
                   int Dv, int G, int window, float scale, int splits,
                   cudaStream_t stream) {
  if (G * BK > NT || G * Dv > NT * MAXO || (Hq / Hkv) % G != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(G * Dk + BK * (Dk | 1) + BK * Dv + G * BK + 3 * G) *
      sizeof(float);
  auto kernel = decode_partial<T, Keys>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, Hq / G, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, keys, Hq, Hkv, Dk,
      Dv, G, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(Hq, B), NT, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Hq, Dv, splits);
  return cudaGetLastError();
}

}  // namespace decode_core
