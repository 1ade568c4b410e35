// Chunked gated delta rule, in two instances of one template:
//
//   * kMasked = true replaces the TPU kernel
//     src/repro/kernels/delta.py::delta_chunked_fused (pallas_call at
//     delta.py:218): the KDA prefill over right-padded rows, H = 56 heads
//     with dk = dv = 128 at full width, bf16 q/k/v, float32 decays, write
//     strengths and state;
//   * kMasked = false replaces src/repro/kernels/delta.py::delta_chunked
//     (pallas_call at delta.py:155): the same rule with every row valid,
//     the forward of training and unpadded evaluation of KDA / GDN mixers.
//     It reads no lengths.
//
// Rows at or past lengths[b] (masked instance) and the tail chunk's rows
// past S (both) are neutralized in-kernel (decay -> 1, k, v -> 0, beta ->
// 0), so the returned state is the state after each row's real tokens,
// whatever bucket padding follows; output rows past a length are computed
// from the neutralized rows.
//
// Both run the two-phase Hopper core of delta_hopper.cuh (the chunk's WY
// factors in parallel over chunks, then the state pass on the tensor
// cores), in bf16 and in float32; this file dispatches on the input type
// and the key dim (padded to 64, 128, 192 or 256).
#include "delta_hopper.cuh"

namespace {

template <typename T, bool kMasked>
cudaError_t by_width(const void* q, const void* k, const void* v,
                     const float* log_a, const float* beta,
                     const int* lengths, const float* s0, void* o, float* sT,
                     char* ws, long long ws_bytes, int B, int H, int S,
                     int dk, int dv, cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  switch (cdiv(dk, 64)) {
#define PRFAAS_DELTA_MT(mt)                                                  \
  case mt:                                                                   \
    return delta_hopper::run<T, kMasked, mt>(qq, kk, vv, log_a, beta,        \
                                             lengths, s0, oo, sT, ws,        \
                                             ws_bytes, B, H, S, dk, dv,      \
                                             stream);
    PRFAAS_DELTA_MT(1)
    PRFAAS_DELTA_MT(2)
    PRFAAS_DELTA_MT(3)
    PRFAAS_DELTA_MT(4)
#undef PRFAAS_DELTA_MT
  }
  return cudaErrorInvalidValue;  // dk outside 1..256
}

template <typename T>
long long ws_by_width(int B, int H, int S, int dk, int dv) {
  switch (cdiv(dk, 64)) {
    case 1: return delta_hopper::Layout<T, 1>::workspace(B, H, S, dv);
    case 2: return delta_hopper::Layout<T, 2>::workspace(B, H, S, dv);
    case 3: return delta_hopper::Layout<T, 3>::workspace(B, H, S, dv);
    case 4: return delta_hopper::Layout<T, 4>::workspace(B, H, S, dv);
  }
  return -1;
}

template <bool kMasked>
int dispatch(const void* q, const void* k, const void* v, const void* log_a,
             const void* beta, const void* lengths, const void* s0, void* o,
             void* sT, void* ws, long long ws_bytes, int B, int H, int S,
             int dk, int dv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bt = static_cast<const float*>(beta);
  const int* lens = static_cast<const int*>(lengths);
  const float* st0 = static_cast<const float*>(s0);
  float* stT = static_cast<float*>(sT);
  char* w = static_cast<char*>(ws);
  if (dtype == kBF16)
    return by_width<__nv_bfloat16, kMasked>(q, k, v, la, bt, lens, st0, o,
                                            stT, w, ws_bytes, B, H, S, dk,
                                            dv, s);
  if (dtype == kF32)
    return by_width<float, kMasked>(q, k, v, la, bt, lens, st0, o, stT, w,
                                    ws_bytes, B, H, S, dk, dv, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the workspace both entry points need at these shapes, or -1
// for a dtype or key dim they refuse.
PRFAAS_API long long prfaas_delta_workspace_bytes(int B, int H, int S, int dk,
                                                  int dv, int dtype) {
  if (dtype == kBF16) return ws_by_width<__nv_bfloat16>(B, H, S, dk, dv);
  if (dtype == kF32) return ws_by_width<float>(B, H, S, dk, dv);
  return -1;
}

// The bf16 parts of the core's float32 operands, in the order T, W, M, S,
// u (kernels/delta.py's PARTS mirrors them).
PRFAAS_API void prfaas_delta_parts(int* parts) {
  const int p[5] = {delta_hopper::PT, delta_hopper::PW, delta_hopper::PM,
                    delta_hopper::PS, delta_hopper::PU};
  for (int i = 0; i < 5; ++i) parts[i] = p[i];
}

// q, k (B,H,S,dk), v (B,H,S,dv) of one dtype; log_a, beta (B,H,S) float32;
// lengths (B,) int32; s0 (B,H,dk,dv) float32; ws a workspace of ws_bytes
// (prfaas_delta_workspace_bytes) -> o (B,H,S,dv) in q's dtype, sT
// (B,H,dk,dv) float32.
PRFAAS_API int prfaas_delta_fused(const void* q, const void* k, const void* v,
                                  const void* log_a, const void* beta,
                                  const void* lengths, const void* s0,
                                  void* o, void* sT, void* ws,
                                  long long ws_bytes, int B, int H, int S,
                                  int dk, int dv, int dtype, void* stream) {
  return dispatch<true>(q, k, v, log_a, beta, lengths, s0, o, sT, ws,
                        ws_bytes, B, H, S, dk, dv, dtype, stream);
}

// The same without lengths: every row of every batch row is valid.
PRFAAS_API int prfaas_delta_chunked(const void* q, const void* k,
                                    const void* v, const void* log_a,
                                    const void* beta, const void* s0, void* o,
                                    void* sT, void* ws, long long ws_bytes,
                                    int B, int H, int S, int dk, int dv,
                                    int dtype, void* stream) {
  return dispatch<false>(q, k, v, log_a, beta, nullptr, s0, o, sT, ws,
                         ws_bytes, B, H, S, dk, dv, dtype, stream);
}
