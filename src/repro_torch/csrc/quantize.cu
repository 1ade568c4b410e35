// Per-tensor symmetric int8 encode of a request's KV-cache leaves for the
// wire, read in place from the bucket-padded prefill cache.
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::quantize_int8_fused
// (pallas_call at quantize.py:78), which encodes one leaf: float32 (the
// leaf cast inside the kernel) in, int8 plus one float32 scale out.  Per
// leaf:
//
//     scale = max(absmax(x), 1e-30) * (1/127)
//     q     = clip(round_half_even(x / scale), -127, 127)
//
// The result must be byte-identical to the plain version, so the divide is
// the IEEE one (__fdiv_rn, never a reciprocal multiply), the rounding is
// rintf (half to even, as torch.round and jnp.round), and the file is built
// without fast math.  A NaN anywhere in a leaf makes its maximum and its
// scale NaN, as torch.max and torch.clamp (and the reference's jnp.max and
// jnp.maximum) give it.
//
// What bounds it on the H100: bytes.  The work reads each element once and
// writes one int8 code; a compare, a divide and a round per element are far
// below the card's rate.  What the design does about it:
//   * It reads the leaves where the prefill left them: each leaf of the
//     table is R segments (request idx's rows [0, n) of an (R, B, S, ...)
//     cache, each segment contiguous) at a stride, in bf16 or float32.
//     There is no trimmed copy and no float32 copy; bf16 -> float is exact,
//     so the codes equal those of the cast leaf.
//   * All leaves of a request go through one launch pair.  Pass 1 lays its
//     blocks over the leaves' element ranges; each thread keeps four
//     16-byte loads in flight, takes |x| by masking the sign bit and the
//     maximum as unsigned integers (for non-negative IEEE values the
//     integer order is the float order, and every NaN lies above +inf, so a
//     NaN wins), and each block writes one partial.  No atomics, no memset,
//     deterministic.  Pass 2 walks the same ranges in reverse order, so its
//     first blocks read what pass 1 read last, still in the 50 MB L2; each
//     block folds its leaf's partials into the scale and writes 8 (bf16) or
//     4 (float32) codes a 16-byte load.  One block a leaf writes the scale,
//     in float32 and, for bf16 leaves, in bf16 (round to nearest even, as
//     torch's cast on the card).
//   * A span whose start is not 16-byte aligned gets a scalar head, its
//     ragged end a scalar tail; where the codes' address is not aligned
//     with the loads (widths such as 257) they are stored byte by byte.
//     Offsets and counts are 64-bit.
#include "common.cuh"

namespace quantize_wire {

constexpr int NT = 256;          // threads a block
constexpr int kUnroll = 4;       // 16-byte loads in flight a thread
constexpr int kMaxLeaves = 16;   // leaves one launch pair takes
constexpr int kFields = 11;      // int64 fields of a leaf in the host table

struct Leaf {
  const char* x;        // first element of segment 0
  int8_t* q;            // the codes, segments * length, contiguous
  float* scale;         // float32 scale
  __nv_bfloat16* scale_bf16;  // the scale in bf16 (bf16 leaves)
  long long stride;     // elements between segment starts
  long long length;     // elements a segment
  long long total;      // segments * length
  long long per_block;  // elements a block covers
  int block0, nblocks, dtype, pad_;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  unsigned* partials;   // |x| maximum of each block, as float bits
  int n, blocks;
};

__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int i = 0;
  while (i + 1 < t.n && b >= t.leaf[i + 1].block0) ++i;
  return i;
}

// the block's maximum of m, on every thread
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) m = max(m, red[w]);
  return m;
}

// |x| as float bits of one element
__device__ __forceinline__ unsigned abs_bits(const float* p) {
  return __float_as_uint(__ldg(p)) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_bits(const __nv_bfloat16* p) {
  return ((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16)
         & 0x7fffffffu;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// running maximum of 16 bytes' |x|: float32 in m, bf16 pairs in m2 (two
// 16-bit maxima a word)
__device__ __forceinline__ void absmax16(const float*, uint4 v, unsigned& m,
                                         unsigned&) {
  m = max(m, max(max(v.x & 0x7fffffffu, v.y & 0x7fffffffu),
                 max(v.z & 0x7fffffffu, v.w & 0x7fffffffu)));
}
__device__ __forceinline__ void absmax16(const __nv_bfloat16*, uint4 v,
                                         unsigned&, unsigned& m2) {
  m2 = __vmaxu2(m2, __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                             __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
}

__device__ __forceinline__ unsigned code(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (unsigned)(int)fminf(fmaxf(r, -127.f), 127.f) & 0xffu;
}

// the codes of 16 bytes of x at o: packed when o is aligned to their size
__device__ __forceinline__ void codes16(const float*, uint4 v, int8_t* o,
                                        float scale, bool packed) {
  const unsigned c0 = code(__uint_as_float(v.x), scale),
                 c1 = code(__uint_as_float(v.y), scale),
                 c2 = code(__uint_as_float(v.z), scale),
                 c3 = code(__uint_as_float(v.w), scale);
  if (packed) {
    *reinterpret_cast<unsigned*>(o) = c0 | c1 << 8 | c2 << 16 | c3 << 24;
  } else {
    o[0] = (int8_t)c0; o[1] = (int8_t)c1; o[2] = (int8_t)c2; o[3] = (int8_t)c3;
  }
}
__device__ __forceinline__ void codes16(const __nv_bfloat16*, uint4 v,
                                        int8_t* o, float scale, bool packed) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned c[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[2 * k] = code(__uint_as_float(w[k] << 16), scale);
    c[2 * k + 1] = code(__uint_as_float(w[k] & 0xffff0000u), scale);
  }
  if (packed) {
    uint2 s;
    s.x = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
    s.y = c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24;
    *reinterpret_cast<uint2*>(o) = s;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (int8_t)c[k];
  }
}

// elements before p's first 16-byte boundary, at most n
template <typename T>
__device__ __forceinline__ long long head_of(const T* p, long long n) {
  const long long h =
      (long long)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
      (long long)sizeof(T);
  return h < n ? h : n;
}

// |x| maximum (float bits) of n contiguous elements at p, this thread's part
template <typename T>
__device__ unsigned absmax_span(const T* p, long long n) {
  constexpr int V = 16 / sizeof(T);
  unsigned m = 0, m2 = 0;
  const long long h = head_of(p, n);
  for (long long i = threadIdx.x; i < h; i += NT) m = max(m, abs_bits(p + i));
  const long long nv = (n - h) / V;
  const uint4* pv = reinterpret_cast<const uint4*>(p + h);
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * NT < nv; i += kUnroll * NT) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(pv + i + u * NT);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) absmax16(p, v[u], m, m2);
  }
  for (; i < nv; i += NT) absmax16(p, __ldg(pv + i), m, m2);
  for (long long j = h + nv * V + threadIdx.x; j < n; j += NT)
    m = max(m, abs_bits(p + j));
  // a bf16 pair's larger half, as float bits
  return max(m, max(m2 << 16, m2 & 0xffff0000u));
}

// the codes of n contiguous elements at p into o, this thread's part
template <typename T>
__device__ void encode_span(const T* p, int8_t* o, long long n, float scale) {
  constexpr int V = 16 / sizeof(T);
  const long long h = head_of(p, n);
  for (long long i = threadIdx.x; i < h; i += NT)
    o[i] = (int8_t)code(load1(p + i), scale);
  const long long nv = (n - h) / V;
  const uint4* pv = reinterpret_cast<const uint4*>(p + h);
  int8_t* ov = o + h;
  const bool packed = (reinterpret_cast<uintptr_t>(ov) % V) == 0;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * NT < nv; i += kUnroll * NT) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(pv + i + u * NT);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      codes16(p, v[u], ov + (i + u * NT) * V, scale, packed);
  }
  for (; i < nv; i += NT) codes16(p, __ldg(pv + i), ov + i * V, scale, packed);
  for (long long j = h + nv * V + threadIdx.x; j < n; j += NT)
    o[j] = (int8_t)code(load1(p + j), scale);
}

// block b's elements [e0, e1) of its leaf, over the segments they cross
__device__ __forceinline__ void block_range(const Leaf& L, int b,
                                            long long& e0, long long& e1) {
  e0 = (long long)(b - L.block0) * L.per_block;
  e1 = e0 + L.per_block < L.total ? e0 + L.per_block : L.total;
}

template <typename T>
__device__ unsigned absmax_range(const Leaf& L, long long e, long long e1) {
  unsigned m = 0;
  if (L.length == 0) return m;
  long long r = e / L.length, a = e - r * L.length;
  const T* x = reinterpret_cast<const T*>(L.x);
  while (e < e1) {
    const long long n = L.length - a < e1 - e ? L.length - a : e1 - e;
    m = max(m, absmax_span(x + r * L.stride + a, n));
    e += n;
    ++r;
    a = 0;
  }
  return m;
}

template <typename T>
__device__ void encode_range(const Leaf& L, long long e, long long e1,
                             float scale) {
  if (L.length == 0) return;
  long long r = e / L.length, a = e - r * L.length;
  const T* x = reinterpret_cast<const T*>(L.x);
  while (e < e1) {
    const long long n = L.length - a < e1 - e ? L.length - a : e1 - e;
    encode_span(x + r * L.stride + a, L.q + e, n, scale);
    e += n;
    ++r;
    a = 0;
  }
}

__global__ void __launch_bounds__(NT) absmax_kernel(const __grid_constant__ Table t) {
  __shared__ unsigned red[NT / 32];
  const int b = blockIdx.x;
  const Leaf& L = t.leaf[leaf_of(t, b)];
  long long e0, e1;
  block_range(L, b, e0, e1);
  unsigned m = L.dtype == kBF16 ? absmax_range<__nv_bfloat16>(L, e0, e1)
                                : absmax_range<float>(L, e0, e1);
  m = block_max(m, red);
  if (threadIdx.x == 0) t.partials[b] = m;
}

__global__ void __launch_bounds__(NT) encode_kernel(const __grid_constant__ Table t) {
  __shared__ unsigned red[NT / 32];
  const int b = t.blocks - 1 - (int)blockIdx.x;   // pass 1's order reversed
  const Leaf& L = t.leaf[leaf_of(t, b)];
  unsigned m = 0;
  for (int i = threadIdx.x; i < L.nblocks; i += NT)
    m = max(m, t.partials[L.block0 + i]);
  const float amax = __uint_as_float(block_max(m, red));
  // max(amax, 1e-30) that keeps a NaN, as torch.clamp
  const float scale = (amax != amax ? amax : fmaxf(amax, 1e-30f)) *
                      (1.0f / 127.0f);
  if (b == L.block0 && threadIdx.x == 0) {
    *L.scale = scale;
    if (L.dtype == kBF16) *L.scale_bf16 = __float2bfloat16_rn(scale);
  }
  long long e0, e1;
  block_range(L, b, e0, e1);
  if (L.dtype == kBF16)
    encode_range<__nv_bfloat16>(L, e0, e1, scale);
  else
    encode_range<float>(L, e0, e1, scale);
}

}  // namespace quantize_wire

// Encode n leaves (1 <= n <= 16) in one launch pair.  `leaves` is the host
// table, 11 int64 a leaf: x (first element of segment 0), q, scale (float32),
// scale_bf16 (bf16 leaves; else unused), dtype (0 float32, 1 bf16),
// segments, stride and length (elements), first block, blocks, elements a
// block.  The leaves' blocks follow each other and number `blocks` in all;
// `partials` is `blocks` uint32 of caller-allocated scratch.
PRFAAS_API int prfaas_quantize_wire(const long long* leaves, int n,
                                    void* partials, int blocks, void* stream) {
  using namespace quantize_wire;
  if (n < 1 || n > kMaxLeaves || blocks < n) return cudaErrorInvalidValue;
  Table t{};
  for (int i = 0; i < n; ++i) {
    const long long* f = leaves + (long long)i * kFields;
    Leaf& L = t.leaf[i];
    L.x = reinterpret_cast<const char*>(f[0]);
    L.q = reinterpret_cast<int8_t*>(f[1]);
    L.scale = reinterpret_cast<float*>(f[2]);
    L.scale_bf16 = reinterpret_cast<__nv_bfloat16*>(f[3]);
    L.dtype = (int)f[4];
    L.stride = f[6];
    L.length = f[7];
    L.total = f[5] * f[7];
    L.block0 = (int)f[8];
    L.nblocks = (int)f[9];
    L.per_block = f[10];
    if ((L.dtype != kF32 && L.dtype != kBF16) || L.nblocks < 1)
      return cudaErrorInvalidValue;
  }
  t.partials = static_cast<unsigned*>(partials);
  t.n = n;
  t.blocks = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  absmax_kernel<<<blocks, NT, 0, s>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  encode_kernel<<<blocks, NT, 0, s>>>(t);
  return cudaGetLastError();
}

PRFAAS_API const char* prfaas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
