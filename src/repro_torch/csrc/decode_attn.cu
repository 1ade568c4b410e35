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
// Design (decode_core.cuh, shared with the paged decode kernel): a block
// owns G query heads of one cache head (G = 16 on the main path, so the
// cache is read Hq / G = 4 times through L2 rather than 64 times) and one
// split of the key axis; a second kernel merges the splits.  Here key j of
// (row b, head hk) is row (b * Hkv + hk) * S + j of the dense cache.
#include "decode_core.cuh"

namespace {

struct DenseKeys {
  static constexpr bool kIndirect = false;
  int S, Hkv;
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    return ((size_t)b * Hkv + hk) * S + j;
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const int* lens,
                void* out, float* pa, float* pm, int B, int Hq, int Hkv,
                int S, int Dk, int Dv, int G, int window, float scale,
                int splits, cudaStream_t s) {
  return decode_core::launch<T>(q, k, v, lens, out, pa, pm,
                                DenseKeys{S, Hkv}, B, Hq, Hkv, Dk, Dv, G,
                                window, scale, splits, s);
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
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(q, k, v, lens, out, pa, pm, B, Hq, Hkv, S, Dk,
                              Dv, G, window, scale, splits, s);
  if (dtype == kF32)
    return run<float>(q, k, v, lens, out, pa, pm, B, Hq, Hkv, S, Dk, Dv, G,
                      window, scale, splits, s);
  return cudaErrorInvalidValue;
}
