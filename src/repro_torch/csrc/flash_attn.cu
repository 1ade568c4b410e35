// Causal / windowed GQA flash attention with a query offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (pallas_call at flash_attn.py:119): the MLA prefill in its decompressed
// MHA form (Hq = Hkv = 64, Dk = 192, Dv = 128 at full width), the GQA
// prefill of mistral-nemo-12b (Hq = 32 over Hkv = 8, D = 128) and the
// chunked-prefill suffix queries over a prior cache (q_offset > 0).
//
// What bounds it on the H100: operations.  A 4096-token causal chunk does
// ~2 * 64 * 4096^2 / 2 * (192 + 128) FLOPs over a few tens of MB of Q/K/V,
// far above the card's ~295 FLOP/byte ridge.  This first version runs the
// products in float32 on the SIMT cores (no tensor cores yet), so it is
// bound by the FP32 FMA rate; wgmma on bf16 tiles is the later step.
//
// Design (flash_core.cuh, shared with the paged-prefill kernel): a block
// owns 64 query rows of one (batch, head) and walks only the 64-key tiles
// its rows can see, online softmax in registers, SIMT float32 products.
// Here key kk of (row b, head hk) is row (b * Hkv + hk) * Sk + kk of the
// dense K and V.
#include "flash_core.cuh"

namespace {

template <typename T>
struct DenseKeys {
  static constexpr bool kIndirect = false;
  const T* k;
  const T* v;
  int S, Hkv, Dk, Dv;
  __device__ __forceinline__ const T* k_row(int b, int hk, int kk) const {
    return k + (((size_t)b * Hkv + hk) * S + kk) * Dk;
  }
  __device__ __forceinline__ const T* v_row(int b, int hk, int kk) const {
    return v + (((size_t)b * Hkv + hk) * S + kk) * Dv;
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Sk, int Dk, int Dv, int q_offset,
                int causal, int window, float scale, cudaStream_t s) {
  DenseKeys<T> keys{static_cast<const T*>(k), static_cast<const T*>(v), Sk,
                    Hkv, Dk, Dv};
  return flash_core::dispatch<T>(q, keys, o, B, Hq, Hkv, Sq, Dk, Dv,
                                 q_offset, causal, window, scale, s);
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
    return run<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv,
                              q_offset, causal, window, scale, s);
  if (dtype == kF32)
    return run<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                      causal, window, scale, s);
  return cudaErrorInvalidValue;
}
