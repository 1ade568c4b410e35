// Suffix-chunk attention over a request's cached prefix in the shared page
// pool followed by its dense suffix, one running softmax across both.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_prefill_attn.py::paged_prefill_attention
// (pallas_call at paged_prefill_attn.py:129).  On the main path it is the
// prefix-hit suffix prefill of mistral-nemo-12b's GQA layers (and of
// zamba2's shared MHA block): a chunk of C queries (Hq = 32 over Hkv = 8
// heads, D = 128, bf16) attends over the N pool pages (T = 16 tokens each)
// its block table names, all visible, and then over the Ssuf suffix keys
// computed so far, causally: query row i sits at suffix position
// Ssuf - C + i.
//
// What bounds it on the H100: operations.  2048 queries over 8192 prior +
// 2048 suffix keys are ~3.1e11 FLOPs over ~34 MB of prior K/V, ~9000
// FLOP/byte, far above the ~295 ridge.
//
// Design: the flash cores over one concatenated key axis of N * T + Ssuf
// positions, with the query offset N * T + Ssuf - C and the causal mask:
// that makes every prior key visible to every query and masks the suffix
// exactly as the TPU kernel does.  The prior is never gathered into a
// dense copy.  Padded query rows of a last chunk see every prior key, so
// their output stays finite.
// * bf16: the tensor-core core of flash_wgmma.cuh.  Its producer warp
//   fills a 64-key tile with 64 / T TMA boxes of T rows: prior key kk is
//   row tables[b, kk / T] * T of head hk in a 3-D map over the (Hkv, P * T,
//   D) pool, read by lane kk % 64 / T one tile ahead; suffix key kk is row
//   kk - N * T of a map over (B * Hkv, Ssuf, D).  A tile that crosses from
//   prior to suffix takes boxes from both.  T must divide 64 and be a
//   multiple of 8 (a box is then whole 1024-byte swizzle atoms).
// * float32: the SIMT core of flash_core.cuh, whose first BK threads
//   resolve each tile's row pointers one tile ahead.
#include "flash_core.cuh"
#include "flash_wgmma.cuh"

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

cudaError_t run_bf16(const void* q, const void* kp, const void* vp,
                     const int* tables, const void* ks, const void* vs,
                     void* o, int B, int Hq, int Hkv, int C, int P, int Tp,
                     int N, int Ssuf, int Dk, int Dv, float scale,
                     cudaStream_t s) {
  using namespace flash_wgmma;
  if (!shapes_ok(Dk, Dv, Hq, Hkv, {q, kp, vp, ks, vs, o}) || Tp <= 0 ||
      Tp % 8 || 64 % Tp || N < 1 || Ssuf < C)
    return cudaErrorInvalidValue;
  Params p{};
  const uint64_t rows = (uint64_t)P * Tp;
  cudaError_t err = make_map(&p.tq, q, Dk, C, (uint64_t)B * Hq, BQ);
  if (err == cudaSuccess) err = make_map(&p.tk, kp, Dk, rows, Hkv, Tp);
  if (err == cudaSuccess) err = make_map(&p.tv, vp, Dv, rows, Hkv, Tp);
  if (err == cudaSuccess)
    err = make_map(&p.tks, ks, Dk, Ssuf, (uint64_t)B * Hkv, Tp);
  if (err == cudaSuccess)
    err = make_map(&p.tvs, vs, Dv, Ssuf, (uint64_t)B * Hkv, Tp);
  if (err != cudaSuccess) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.tables = tables;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = C;
  p.Sk = N * Tp + Ssuf;
  p.Dv = Dv;
  p.q_offset = N * Tp + Ssuf - C;
  p.causal = 1;
  p.window = 0;
  p.N = N;
  p.T = Tp;
  p.prior = N * Tp;
  p.scale_log2 = scale_log2(scale);
  return dispatch</*kPaged=*/true>(p, B, Dk, s);
}

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
// k_suf (B,Hkv,Ssuf,Dk), v_suf (B,Hkv,Ssuf,Dv), Ssuf >= C -> o (B,Hq,C,Dv)
// (bf16: head dims multiples of 8 up to 256, 16-byte aligned pointers, T
// a multiple of 8 dividing 64).
PRFAAS_API int prfaas_paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* k_suf, const void* v_suf, void* o, int B,
    int Hq, int Hkv, int C, int P, int T, int N, int Ssuf, int Dk, int Dv,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  if (dtype == kBF16)
    return run_bf16(q, k_pages, v_pages, tbl, k_suf, v_suf, o, B, Hq, Hkv, C,
                    P, T, N, Ssuf, Dk, Dv, scale, s);
  if (dtype == kF32)
    return run<float>(q, k_pages, v_pages, tbl, k_suf, v_suf, o, B, Hq, Hkv,
                      C, P, T, N, Ssuf, Dk, Dv, scale, s);
  return cudaErrorInvalidValue;
}
