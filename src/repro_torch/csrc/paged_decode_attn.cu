// One-query flash-decode over a shared page pool, through per-row block
// tables, with per-row lengths and a sliding-window mask.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_decode_attn.py::paged_decode_attention
// (pallas_call at paged_decode_attn.py:112).  On the main path it is the
// paged decode of two architectures, bf16, pages of T = 16 tokens:
//   * MLA (kimi-linear-1t, absorbed): Hq = 64 query heads over one latent
//     head, Dk = 536 (k = [ckv, kpe] pool), Dv = 472 (v = ckv pool);
//   * GQA (mistral-nemo-12b): Hq = 32 over Hkv = 8 heads of D = 128.
//
// What bounds it on the H100: bytes.  As for the dense decode kernel, each
// live key is (Dk + Dv) * 2 bytes for 2 * (Hq / Hkv) * (Dk + Dv) FLOPs, at
// most 64 FLOP/byte, under the ~295 ridge: the live pages have to stream
// from HBM once.
//
// Design: the dense flash-decode (decode_core.cuh) with the page table
// resolved inside the kernel.  Key j of (row b, head hk) lives in physical
// page tables[b, j / T] at row j % T, so its key-row index in the pool
// (Hkv, P, T, D) is (hk * P + tables[b, j / T]) * T + j % T; the pool is
// never gathered into a dense copy.  The key range, not the pages, is split
// over blocks (T = 16 is one tile, too small a block of work): each block
// walks many pages, splits aligned to whole tiles by the wrapper, and
// resolves each tile's pages one tile ahead.  Pages at or past lengths[b]
// (sink or garbage pages, which retired slots write every step) are never
// read, table entries included; within the last page the dead rows are
// filled by selection, never by arithmetic.
#include "decode_core.cuh"

namespace {

struct PagedKeys {
  static constexpr bool kIndirect = true;
  const int* tables;   // (B, N) physical page ids
  int S, N, P, Tp;     // S = N * Tp key positions per row, Tp per page
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    const int page = tables[(size_t)b * N + j / Tp];
    return ((size_t)hk * P + page) * Tp + j % Tp;
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const int* tables, const int* lens, void* out, float* pa,
                float* pm, int B, int Hq, int Hkv, int P, int Tp, int N,
                int Dk, int Dv, int G, int window, float scale, int splits,
                cudaStream_t s) {
  return decode_core::launch<T>(q, k, v, lens, out, pa, pm,
                                PagedKeys{tables, N * Tp, N, P, Tp}, B, Hq,
                                Hkv, Dk, Dv, G, window, scale, splits, s);
}

}  // namespace

// q (B,Hq,Dk), k pool (Hkv,P,T,Dk), v pool (Hkv,P,T,Dv), tables (B,N)
// int32, lengths (B,) int32 -> out (B,Hq,Dv).  part_acc (B,Hq,splits,Dv)
// and part_ml (B,Hq,splits,2) are float32 scratch the caller allocates.
PRFAAS_API int prfaas_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, void* part_acc, void* part_ml, int B,
    int Hq, int Hkv, int P, int T, int N, int Dk, int Dv, int G, int window,
    float scale, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(q, k, v, tbl, lens, out, pa, pm, B, Hq, Hkv, P,
                              T, N, Dk, Dv, G, window, scale, splits, s);
  if (dtype == kF32)
    return run<float>(q, k, v, tbl, lens, out, pa, pm, B, Hq, Hkv, P, T, N,
                      Dk, Dv, G, window, scale, splits, s);
  return cudaErrorInvalidValue;
}
