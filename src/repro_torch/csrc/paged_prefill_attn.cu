// Suffix-chunk attention over a request's cached prefix in the shared page
// pool followed by its dense suffix, one running softmax across both.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_prefill_attn.py::paged_prefill_attention
// (pallas_call at paged_prefill_attn.py:129).  On the main path it is the
// prefix-hit suffix prefill of mistral-nemo-12b's GQA layers: a chunk of C
// queries (Hq = 32 over Hkv = 8 heads, D = 128, bf16) attends over the N
// pool pages (T = 16 tokens each) its block table names, all visible, and
// then over the Ssuf suffix keys computed so far, causally: query row i
// sits at suffix position Ssuf - C + i.
//
// What bounds it on the H100: operations.  At the smoke shape (2048
// queries over 8192 prior + 2048 suffix keys) it does ~3.1e11 FLOPs over
// ~34 MB of prior K/V, ~9000 FLOP/byte, far above the ~295 ridge.  As the
// dense flash kernel it runs SIMT float32 products for now.
//
// Design: the dense flash kernel (flash_core.cuh) over one concatenated key
// axis of N * T + Ssuf positions, with the query offset N * T + Ssuf - C
// and the causal mask: that makes every prior key visible to every query
// and masks the suffix exactly as the TPU kernel does.  A 64-key tile
// resolves its rows itself: key kk < N * T lives in pool page
// tables[b, kk / T] at row kk % T, i.e. K row (hk * P + page) * T + kk % T
// of the (Hkv, P, T, D) pool, and key kk >= N * T is suffix row
// kk - N * T.  The table is walked tile by tile; the prior is never
// gathered into a dense copy.  Padded query rows of a last chunk see every
// prior key, so their output stays finite.
#include "flash_core.cuh"

namespace {

template <typename T>
struct PagedPrefixKeys {
  static constexpr bool kIndirect = true;
  const T* kp;          // (Hkv, P, T, Dk) pool
  const T* vp;          // (Hkv, P, T, Dv) pool
  const T* ks;          // (B, Hkv, Ssuf, Dk) suffix
  const T* vs;          // (B, Hkv, Ssuf, Dv) suffix
  const int* tables;    // (B, N)
  int S, N, P, Tp, Ssuf, Hkv, Dk, Dv;  // S = N * Tp + Ssuf
  __device__ __forceinline__ size_t pool_row(int b, int hk, int kk) const {
    return ((size_t)hk * P + tables[(size_t)b * N + kk / Tp]) * Tp + kk % Tp;
  }
  __device__ __forceinline__ size_t suf_row(int b, int hk, int kk) const {
    return ((size_t)b * Hkv + hk) * Ssuf + (kk - N * Tp);
  }
  __device__ __forceinline__ const T* k_row(int b, int hk, int kk) const {
    return kk < N * Tp ? kp + pool_row(b, hk, kk) * Dk
                       : ks + suf_row(b, hk, kk) * Dk;
  }
  __device__ __forceinline__ const T* v_row(int b, int hk, int kk) const {
    return kk < N * Tp ? vp + pool_row(b, hk, kk) * Dv
                       : vs + suf_row(b, hk, kk) * Dv;
  }
};

template <typename T>
cudaError_t run(const void* q, const void* kp, const void* vp,
                const int* tables, const void* ks, const void* vs, void* o,
                int B, int Hq, int Hkv, int C, int P, int Tp, int N, int Ssuf,
                int Dk, int Dv, float scale, cudaStream_t s) {
  PagedPrefixKeys<T> keys{static_cast<const T*>(kp),
                          static_cast<const T*>(vp),
                          static_cast<const T*>(ks),
                          static_cast<const T*>(vs), tables, N * Tp + Ssuf,
                          N, P, Tp, Ssuf, Hkv, Dk, Dv};
  return flash_core::dispatch<T>(q, keys, o, B, Hq, Hkv, C, Dk, Dv,
                                 N * Tp + Ssuf - C, /*causal=*/1,
                                 /*window=*/0, scale, s);
}

}  // namespace

// q (B,Hq,C,Dk), pools (Hkv,P,T,Dk) / (Hkv,P,T,Dv), tables (B,N) int32,
// k_suf (B,Hkv,Ssuf,Dk), v_suf (B,Hkv,Ssuf,Dv), Ssuf >= C -> o (B,Hq,C,Dv).
PRFAAS_API int prfaas_paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* k_suf, const void* v_suf, void* o, int B,
    int Hq, int Hkv, int C, int P, int T, int N, int Ssuf, int Dk, int Dv,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(q, k_pages, v_pages, tbl, k_suf, v_suf, o, B,
                              Hq, Hkv, C, P, T, N, Ssuf, Dk, Dv, scale, s);
  if (dtype == kF32)
    return run<float>(q, k_pages, v_pages, tbl, k_suf, v_suf, o, B, Hq, Hkv,
                      C, P, T, N, Ssuf, Dk, Dv, scale, s);
  return cudaErrorInvalidValue;
}
