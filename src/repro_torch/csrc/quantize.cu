// Per-tensor symmetric int8 encode of one KV-cache leaf for the wire.
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::quantize_int8_fused
// (pallas_call at quantize.py:78): the wire format's encode of the MLA
// latents (ckv (1, 1, L, 472) and kpe (1, 1, L, 64) per request at full
// width), float32 in, int8 plus one float32 scale out.
//
//     scale = max(absmax(x), 1e-30) * (1/127)
//     q     = clip(round_half_even(x / scale), -127, 127)
//
// The result must be byte-identical to the plain version, so the divide is
// the IEEE one (__fdiv_rn, never a reciprocal multiply) and the rounding is
// rintf (half to even, as torch.round and jnp.round), and the file is built
// without fast math.
//
// What bounds it on the H100: bytes.  It reads the leaf twice (absmax, then
// encode) and writes a quarter of it, with one compare or a few flops per
// element.
//
// Design: the TPU kernel's two-phase sequential grid becomes two launches.
// Phase one reduces |x| per block through warp shuffles and folds the block
// maxima into one word with atomicMax on the float's bit pattern, which
// orders like the float for non-negative values.  Phase two derives the
// scale from that word, encodes with a grid-stride loop, and block 0 writes
// the scale.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
absmax_kernel(const float* __restrict__ x, long long n,
              unsigned int* __restrict__ amax_bits) {
  __shared__ float warp_max[NT / 32];
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT)
    m = fmaxf(m, fabsf(x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = 0.f;
    for (int w = 0; w < NT / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    atomicMax(amax_bits, __float_as_uint(bm));
  }
}

__global__ void __launch_bounds__(NT)
encode_kernel(const float* __restrict__ x, long long n,
              const unsigned int* __restrict__ amax_bits,
              int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const float scale = fmaxf(__uint_as_float(*amax_bits), 1e-30f) * (1.0f / 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const float r = rintf(__fdiv_rn(x[i], scale));
    q[i] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
  }
}

}  // namespace

// x (n,) float32 -> q (n,) int8, scale (1,) float32.  amax_bits is one
// uint32 of caller-allocated scratch (zeroed here on the stream); sms is the
// device's multiprocessor count, which caps the grid at 8 blocks per SM.
PRFAAS_API int prfaas_quantize_int8(const void* x, void* q, void* scale,
                                    void* amax_bits, long long n, int sms,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(n > 0 ? (n + NT * 8 - 1) / (NT * 8) : 1);
  const int grid = blocks < sms * 8 ? blocks : sms * 8;
  absmax_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(x), n,
                                    static_cast<unsigned int*>(amax_bits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  encode_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), n,
      static_cast<const unsigned int*>(amax_bits), static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return cudaGetLastError();
}

PRFAAS_API const char* prfaas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
