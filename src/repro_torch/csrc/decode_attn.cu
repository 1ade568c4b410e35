// One-query flash-decode over a dense per-slot cache, with per-row lengths
// and a sliding-window mask.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py::decode_attention
// (pallas_call at decode_attn.py:94).  On the main paths it is
//   * the absorbed MLA decode (kimi-linear-1t): MQA over the latent cache,
//     Hq = 64 query heads against Hkv = 1 cache head, Dk = 472 + 64 = 536
//     (k = [ckv, kpe]) and Dv = 472 (v = ckv), bf16;
//   * zamba2-1.2b's shared MHA block: Hq = Hkv = 32 heads of D = 64, bf16,
//     read in place from the (B, S, Hkv, D) cache the model keeps.
//
// What bounds it on the H100: bytes.  Each live key costs (Dk + Dv) * 2
// bytes and 2 * (Hq / Hkv) * (Dk + Dv) FLOPs, at most 64 FLOP/byte, under
// the ~295 ridge: the live keys have to stream from HBM once, and the time
// is that stream.
//
// Design: bf16 runs the Hopper core of decode_hopper.cuh (tensor cores at
// MLA, a pipelined bf16 stream at GQA/MHA, key runs balanced across rows);
// float32 keeps the SIMT core of decode_core.cuh.  Both read key j of
// (row b, head hk) at key row b * rB + hk * rH + j * rS, in units of one
// key row (Dk elements of k, Dv of v): rS = 1 for a contiguous
// (B, Hkv, S, D) cache, rS = Hkv for the (B, S, Hkv, D) one seen through
// a transpose, so neither is copied.
#include "decode_core.cuh"
#include "decode_hopper.cuh"

namespace {

struct DenseKeys {
  static constexpr bool kIndirect = false;
  int S;
  long long rB, rH, rS;
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    return (size_t)(b * rB + hk * rH + j * rS);
  }
};

}  // namespace

// q (B,Hq,Dk); k (B,Hkv,S,Dk) and v (B,Hkv,S,Dv) with key rows at
// (b * rB + hk * rH + j * rS) * Dk / * Dv; lengths (B,) int32 -> out
// (B,Hq,Dv).  float32: G query heads a block, `splits` runs per row,
// part_acc (B,Hq,splits,Dv) and part_ml (B,Hq,splits,2) float32 scratch.
// bfloat16: G query heads a stream worker (or 64 rows at G >= 16),
// `splits` workers a head tile, `tile` keys a tile, at most `runs` runs a
// row of at least `rmin` tiles each, part_acc (B * runs, Hq, Dv) and
// part_ml (B * runs, Hq, 2); float32 ignores runs and rmin.
PRFAAS_API int prfaas_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, long long rB, long long rH,
    long long rS, int B, int Hq, int Hkv, int S, int Dk, int Dv, int G,
    int window, float scale, int splits, int tile, int runs,
    int rmin, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const DenseKeys keys{S, rB, rH, rS};
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
