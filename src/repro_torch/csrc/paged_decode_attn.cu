// One-query flash-decode over a shared page pool, through per-row block
// tables, with per-row lengths and a sliding-window mask.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_decode_attn.py::paged_decode_attention
// (pallas_call at paged_decode_attn.py:112).  On the main paths it is the
// paged decode of three architectures, bf16, pages of T = 16 tokens:
//   * MLA (kimi-linear-1t, absorbed): Hq = 64 query heads over one latent
//     head, Dk = 536 (k = [ckv, kpe] pool), Dv = 472 (v = ckv pool);
//   * GQA (mistral-nemo-12b): Hq = 32 over Hkv = 8 heads of D = 128;
//   * MHA (zamba2-1.2b's shared block): Hq = Hkv = 32 heads of D = 64.
//
// What bounds it on the H100: bytes.  As for the dense decode kernel, each
// live key is (Dk + Dv) * 2 bytes for 2 * (Hq / Hkv) * (Dk + Dv) FLOPs, at
// most 64 FLOP/byte, under the ~295 ridge: the live pages have to stream
// from HBM once.
//
// Design: the dense flash-decode (decode_hopper.cuh for bf16,
// decode_core.cuh for float32) with the page table resolved inside the
// kernel.  Key j of (row b, head hk) lives in physical page tables[b, j /
// T] at row j % T, so its key-row index in the pool (Hkv, P, T, D) is
// (hk * P + tables[b, j / T]) * T + j % T; the pool is never gathered into
// a dense copy.  The bf16 core loads each key row with 16-byte cp.async at
// its own page, so any page size works; pages at or past lengths[b] (sink
// or garbage pages, which retired slots write every step) are never read,
// table entries included, and within the last page the dead rows are
// zero-filled in shared memory and masked by selection.
#include "decode_core.cuh"
#include "decode_hopper.cuh"

namespace {

struct PagedKeys {
  static constexpr bool kIndirect = true;
  const int* tables;   // (B, N) physical page ids
  int S, N, P, Tp;     // S = N * Tp key positions per row, Tp per page
  int shift;           // log2(Tp) where Tp is a power of two, else -1
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    // a shift where it can: a division by a runtime Tp costs ~25
    // instructions a key in the bf16 stream's loads
    const int lp = shift >= 0 ? j >> shift : j / Tp;
    const int page = __ldg(tables + (size_t)b * N + lp);
    return ((size_t)hk * P + page) * Tp + (j - lp * Tp);
  }
};

}  // namespace

// q (B,Hq,Dk), k pool (Hkv,P,T,Dk), v pool (Hkv,P,T,Dv), tables (B,N)
// int32, lengths (B,) int32 -> out (B,Hq,Dv).  G, splits, tile, runs,
// rmin and the float32 scratch part_acc / part_ml as for
// prfaas_decode_attention.
PRFAAS_API int prfaas_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, void* part_acc, void* part_ml, int B,
    int Hq, int Hkv, int P, int T, int N, int Dk, int Dv, int G, int window,
    float scale, int splits, int tile, int runs,
    int rmin, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int shift = 0;
  while ((1 << shift) < T) ++shift;
  const PagedKeys keys{static_cast<const int*>(tables), N * T, N, P, T,
                       (1 << shift) == T ? shift : -1};
  if (dtype == kBF16) {
    decode_hopper::Args a{q, k, v, lens, out, pa, pm, B, Hq, Hkv, Dk, Dv, G,
                          splits, window, tile, runs, rmin,
                          decode_hopper::scale_log2(scale)};
    return decode_hopper::launch(a, keys, s);
  }
  if (dtype == kF32)
    return decode_core::launch<float>(q, k, v, lens, out, pa, pm, keys, B,
                                      Hq, Hkv, Dk, Dv, G, window, scale,
                                      splits, s);
  return cudaErrorInvalidValue;
}
