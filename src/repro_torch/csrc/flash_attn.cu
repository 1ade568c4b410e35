// Causal / windowed GQA flash attention with a query offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (pallas_call at flash_attn.py:119): the MLA prefill in its decompressed
// MHA form (Hq = Hkv = 64, Dk = 192, Dv = 128 at full width), the GQA
// prefill of mistral-nemo-12b (Hq = 32 over Hkv = 8, D = 128), zamba2's
// shared MHA block (D = 64), the chunked-prefill suffix queries over a
// prior cache (q_offset > 0) and the training forwards.
//
// What bounds it on the H100: operations.  A 2048-token causal MLA chunk
// does 2 * 64 * 2048 * 2049 / 2 * (192 + 128) = 8.6e10 FLOPs over ~120 MB
// of Q/K/V/O, ~700 FLOP/byte, above the card's ~295 FLOP/byte ridge.
//
// Design: bf16 runs the tensor-core core of flash_wgmma.cuh (wgmma for
// Q K^T and P V, a TMA ring of K/V tiles fed by a producer warpgroup, 128
// query rows a block, causal and window tile skipping); key kk of (row b,
// head hk) is row kk of the 3-D TMA map over (B * Hkv, Sk, D).  float32
// keeps the SIMT core of flash_core.cuh (a tensor-core float32 product is
// TF32, short of the float32 tolerance): 64 query rows a block, float32
// FMAs.
#include "flash_core.cuh"
#include "flash_wgmma.cuh"

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

cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int Dk, int Dv,
                     int q_offset, int causal, int window, float scale,
                     cudaStream_t s) {
  using namespace flash_wgmma;
  if (!shapes_ok(Dk, Dv, Hq, Hkv, {q, k, v, o})) return cudaErrorInvalidValue;
  if (Sk == 0)  // no key: every row writes 0
    return cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * Dv * 2, s);
  const int bk = tile_keys((Dk + 63) / 64, (Dv + 63) / 64);
  Params p{};
  cudaError_t err = make_map(&p.tq, q, Dk, Sq, (uint64_t)B * Hq, BQ);
  if (err == cudaSuccess)
    err = make_map(&p.tk, k, Dk, Sk, (uint64_t)B * Hkv, bk);
  if (err == cudaSuccess)
    err = make_map(&p.tv, v, Dv, Sk, (uint64_t)B * Hkv, bk);
  if (err != cudaSuccess) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Dv = Dv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale_log2(scale);
  return dispatch</*kPaged=*/false>(p, B, Dk, s);
}

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
// all contiguous and of one dtype (kF32 or kBF16; bf16 head dims multiples
// of 8 up to 256 and 16-byte aligned pointers).
PRFAAS_API int prfaas_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int Dk, int Dv,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run_bf16(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset, causal,
                    window, scale, s);
  if (dtype == kF32)
    return run<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                      causal, window, scale, s);
  return cudaErrorInvalidValue;
}
