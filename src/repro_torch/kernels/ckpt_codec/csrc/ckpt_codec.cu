// Checkpoint codec kernels for Hopper (sm_90a): the port of the Pallas
// kernels in src/repro/kernels/ckpt_codec/ckpt_codec.py.
//
//   K1 delta_encode_kernel<true>   <- delta_encode_digest_pallas (_encode_digest_kernel)
//   K2 bf16_encode_digest_kernel   <- bf16_encode_digest_pallas  (_bf16_digest_kernel)
//   K3 delta_decode_kernel         <- delta_decode_pallas        (_decode_kernel)
//   K4 delta_encode_kernel<false>  <- delta_encode_pallas        (_encode_kernel)
//   K5 digest_blocks_kernel        <- digest_blocks_pallas       (_digest_kernel)
//
// Data layout: [nblk, blk] row-major, one codec block (16384 fp32 on the main
// path) per CTA, as the Pallas grid had one block per grid step (K5: four
// blocks per CTA, see below). blk must be a multiple of 4 (8 for K5) and every
// pointer 16-byte aligned (checked by the Python wrapper), so all traffic is
// 16-byte vector loads and stores.
//
// Bound: every kernel streams device memory once and does a handful of
// operations per element (~9 B/element for K1, K3, K4; 6 B for K2; 4 or 2 B
// for K5), so all five are bound by HBM bandwidth. K1/K4 keep the block's delta
// (64 KiB) in dynamic shared memory between the amax pass and the quantize
// pass, so x and prev are read from HBM once.
//
// Bit-identity with the plain versions (ref.py) is the contract. They compute
// the JAX package's codec as XLA runs it, so images match byte for byte:
//   - build WITHOUT --use_fast_math;
//   - scale = amax * fl32(1/127) (XLA turns the division by the constant 127
//     into a multiplication by its fp32 reciprocal), __fmul_rn;
//   - inv = 1/max(scale, 1e-30f) is an IEEE division, __fdiv_rn;
//   - rintf rounds half to even, like jnp.round / torch.round;
//   - decode is __fmaf_rn(q, scale, prev), rounded once: XLA:CPU contracts
//     prev + q*scale into an FMA; the explicit intrinsic fixes the contraction
//     instead of leaving it to nvcc's --fmad;
//   - digest lanes are uint32 products and sums, whose wraparound is the
//     mod-2^32 arithmetic of the reference; amax and the lane sums are exact
//     and order-independent, so any reduction tree gives the same bits.
// The codec's contract covers finite inputs (NaN handling of fmaxf differs
// from jnp.max). K5 only reads bit patterns, so it covers every input.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDecodeThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32 0x3C010204

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max of non-negative values; every thread gets the result.
// Contains a __syncthreads, so shared-memory writes before it are visible after.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
  return warp_max(v);
}

// Block-wide wraparound uint32 sums of two lanes; every thread gets them.
__device__ __forceinline__ void block_sum2(uint32_t& a, uint32_t& b) {
  __shared__ uint32_t red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  const bool in = lane < (int)(blockDim.x >> 5);
  a = warp_sum(in ? red[0][lane] : 0u);
  b = warp_sum(in ? red[1][lane] : 0u);
}

// clip(round_half_even(d * inv), -127, 127)
__device__ __forceinline__ int quantize(float d, float inv) {
  float r = rintf(__fmul_rn(d, inv));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int>(r);
}

// K1 (kDigest) / K4: d = x - prev; amax = max|d|; dirty = amax > 0;
// scale = amax * fl32(1/127); q = clip(round(d * (1/max(scale, 1e-30))), +-127)
// as int8;
// K1 also folds the int8 payload bytes into two pmac32 lanes
// sum((q & 0xFF) * w_k[i]) mod 2^32.
template <bool kDigest>
__global__ void __launch_bounds__(kThreads)
    delta_encode_kernel(const float* __restrict__ x, const float* __restrict__ prev,
                        const uint32_t* __restrict__ w, int8_t* __restrict__ q,
                        float* __restrict__ scale_out, bool* __restrict__ dirty_out,
                        uint32_t* __restrict__ h1_out, uint32_t* __restrict__ h2_out,
                        int blk) {
  extern __shared__ float4 d_s[];  // blk/4 float4: this block's delta
  const int nv = blk >> 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(blk);
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* p4 = reinterpret_cast<const float4*>(prev + base);

  float amax = 0.0f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 a = x4[i];
    const float4 b = p4[i];
    float4 d;
    d.x = __fsub_rn(a.x, b.x);
    d.y = __fsub_rn(a.y, b.y);
    d.z = __fsub_rn(a.z, b.z);
    d.w = __fsub_rn(a.w, b.w);
    d_s[i] = d;
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(d.x), fabsf(d.y)),
                             fmaxf(fabsf(d.z), fabsf(d.w))));
  }
  amax = block_max(amax);
  const bool dirty = amax > 0.0f;
  const float scale = dirty ? __fmul_rn(amax, kInv127) : 0.0f;
  const float inv = dirty ? __fdiv_rn(1.0f, fmaxf(scale, 1e-30f)) : 0.0f;

  char4* q4 = reinterpret_cast<char4*>(q + base);
  uint32_t s1 = 0u, s2 = 0u;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 d = d_s[i];
    const int a = quantize(d.x, inv), b = quantize(d.y, inv);
    const int c = quantize(d.z, inv), e = quantize(d.w, inv);
    q4[i] = make_char4(static_cast<signed char>(a), static_cast<signed char>(b),
                       static_cast<signed char>(c), static_cast<signed char>(e));
    if constexpr (kDigest) {
      const uint4 u = reinterpret_cast<const uint4*>(w)[i];
      const uint4 v = reinterpret_cast<const uint4*>(w + blk)[i];
      const uint32_t ua = static_cast<uint32_t>(a) & 0xFFu;
      const uint32_t ub = static_cast<uint32_t>(b) & 0xFFu;
      const uint32_t uc = static_cast<uint32_t>(c) & 0xFFu;
      const uint32_t ue = static_cast<uint32_t>(e) & 0xFFu;
      s1 += ua * u.x + ub * u.y + uc * u.z + ue * u.w;
      s2 += ua * v.x + ub * v.y + uc * v.z + ue * v.w;
    }
  }
  if (threadIdx.x == 0) {
    scale_out[blockIdx.x] = scale;
    dirty_out[blockIdx.x] = dirty;
  }
  if constexpr (kDigest) {
    block_sum2(s1, s2);
    if (threadIdx.x == 0) {
      h1_out[blockIdx.x] = s1;
      h2_out[blockIdx.x] = s2;
    }
  }
}

// K2: y = bf16(x) (round to nearest even) + lanes over the bf16 bit patterns.
__global__ void __launch_bounds__(kThreads)
    bf16_encode_digest_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                              uint16_t* __restrict__ y, uint32_t* __restrict__ h1_out,
                              uint32_t* __restrict__ h2_out, int blk) {
  const int nv = blk >> 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(blk);
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  ushort4* y4 = reinterpret_cast<ushort4*>(y + base);
  const uint4* w0 = reinterpret_cast<const uint4*>(w);
  const uint4* w1 = reinterpret_cast<const uint4*>(w + blk);

  uint32_t s1 = 0u, s2 = 0u;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 a = x4[i];
    const unsigned short b0 = __bfloat16_as_ushort(__float2bfloat16_rn(a.x));
    const unsigned short b1 = __bfloat16_as_ushort(__float2bfloat16_rn(a.y));
    const unsigned short b2 = __bfloat16_as_ushort(__float2bfloat16_rn(a.z));
    const unsigned short b3 = __bfloat16_as_ushort(__float2bfloat16_rn(a.w));
    y4[i] = make_ushort4(b0, b1, b2, b3);
    const uint4 u = w0[i];
    const uint4 v = w1[i];
    s1 += static_cast<uint32_t>(b0) * u.x + static_cast<uint32_t>(b1) * u.y +
          static_cast<uint32_t>(b2) * u.z + static_cast<uint32_t>(b3) * u.w;
    s2 += static_cast<uint32_t>(b0) * v.x + static_cast<uint32_t>(b1) * v.y +
          static_cast<uint32_t>(b2) * v.z + static_cast<uint32_t>(b3) * v.w;
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    h1_out[blockIdx.x] = s1;
    h2_out[blockIdx.x] = s2;
  }
}

// K3: out = fma(q, scale[blk], prev) in fp32, rounded once.
__global__ void __launch_bounds__(kDecodeThreads)
    delta_decode_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                        const float* __restrict__ prev, float* __restrict__ out, int blk) {
  const int nv = blk >> 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(blk);
  const char4* q4 = reinterpret_cast<const char4*>(q + base);
  const float4* p4 = reinterpret_cast<const float4*>(prev + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  const float s = scale[blockIdx.x];
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const char4 c = q4[i];
    const float4 p = p4[i];
    float4 o;
    o.x = __fmaf_rn(static_cast<float>(c.x), s, p.x);
    o.y = __fmaf_rn(static_cast<float>(c.y), s, p.y);
    o.z = __fmaf_rn(static_cast<float>(c.z), s, p.z);
    o.w = __fmaf_rn(static_cast<float>(c.w), s, p.w);
    o4[i] = o;
  }
}

// K5: per block, two lanes sum(bits(fp32(x_i)) * w_k[i]) mod 2^32 over the raw
// block -- the digest-only sweep of the Pallas kernel -- and, in the same pass,
// the pre-dump classifier's second pair over fmix32(bits + w_1[i]) (see
// ref.mixed_lanes_ref: the raw lanes are linear in the bits, so a change that
// is uniform over a block, such as x -> 2x or x -> -x, can cancel in them).
// x is a flat fp32 or bf16 buffer of n elements; block b covers
// [b*blk, (b+1)*blk) and elements past n count as zero (the zero padding of
// ops.digest_blocks), so a ragged leaf needs no padded copy. bf16 widens by
// bits << 16, which is the exact fp32 cast of the Pallas kernel, done in
// registers.
//
// Each CTA digests kDigestGroup consecutive blocks at once: a thread loads the
// weights of one position once and applies them to that position in every
// block of the group, which cuts the weight table's L2 traffic to a quarter of
// x's bytes (one block per CTA would read twice x's bytes of weights).
constexpr int kDigestGroup = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

template <bool kBf16>
__device__ __forceinline__ void load_units(const void* x, long long e0, long long n,
                                           uint32_t* u) {
  constexpr int kVec = kBf16 ? 8 : 4;  // elements per 16-byte load
  if (e0 + kVec <= n) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + e0 * (kBf16 ? 2 : 4)));
    if constexpr (kBf16) {
      const uint32_t p[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // little endian: the lower element is
        u[2 * j] = p[j] << 16;       // the low half
        u[2 * j + 1] = p[j] & 0xFFFF0000u;
      }
    } else {
      u[0] = q.x;
      u[1] = q.y;
      u[2] = q.z;
      u[3] = q.w;
    }
  } else {  // the ragged end of the last block
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long e = e0 + j;
      if (e >= n) {
        u[j] = 0u;
      } else if constexpr (kBf16) {
        u[j] = static_cast<uint32_t>(static_cast<const uint16_t*>(x)[e]) << 16;
      } else {
        u[j] = static_cast<const uint32_t*>(x)[e];
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    digest_blocks_kernel(const void* __restrict__ x, const uint32_t* __restrict__ w,
                         uint32_t* __restrict__ out, long long n, long long nblk, int blk) {
  constexpr int kVec = kBf16 ? 8 : 4;
  const int nv = blk / kVec;
  const long long b0 = static_cast<long long>(blockIdx.x) * kDigestGroup;
  uint32_t acc[kDigestGroup][4];  // h1, h2, g1, g2 of each block of the group
#pragma unroll
  for (int g = 0; g < kDigestGroup; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0u;

  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    uint32_t w0[kVec], w1[kVec];
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      const uint4 a = reinterpret_cast<const uint4*>(w + v * kVec + j)[0];
      const uint4 c = reinterpret_cast<const uint4*>(w + blk + v * kVec + j)[0];
      w0[j] = a.x; w0[j + 1] = a.y; w0[j + 2] = a.z; w0[j + 3] = a.w;
      w1[j] = c.x; w1[j + 1] = c.y; w1[j + 2] = c.z; w1[j + 3] = c.w;
    }
#pragma unroll
    for (int g = 0; g < kDigestGroup; ++g) {
      const long long b = b0 + g;
      if (b < nblk) {
        uint32_t u[kVec];
        load_units<kBf16>(x, b * blk + static_cast<long long>(v) * kVec, n, u);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const uint32_t m = fmix32(u[j] + w0[j]);
          acc[g][0] += u[j] * w0[j];
          acc[g][1] += u[j] * w1[j];
          acc[g][2] += m * w0[j];
          acc[g][3] += m * w1[j];
        }
      }
    }
  }

  // wraparound sums are exact in any order: warps first, then warp g sums
  // block g's per-warp partials; lanes 0-3 of that warp write its 4 lanes
  __shared__ uint32_t red[kDigestGroup][4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kDigestGroup; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = warp_sum(acc[g][k]);
      if (lane == 0) red[g][k][warp] = a;
    }
  }
  __syncthreads();
  if (warp < kDigestGroup && b0 + warp < nblk) {
    const bool in = lane < (int)(blockDim.x >> 5);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = warp_sum(in ? red[warp][k][lane] : 0u);
      if (lane == 0) out[k * nblk + b0 + warp] = a;
    }
  }
}

template <bool kDigest>
int launch_encode(const void* x, const void* prev, const void* w, void* q, void* scale,
                  void* dirty, void* h1, void* h2, long long nblk, int blk, void* stream) {
  const size_t smem = static_cast<size_t>(blk) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(delta_encode_kernel<kDigest>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  delta_encode_kernel<kDigest><<<static_cast<unsigned>(nblk), kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(prev),
      static_cast<const uint32_t*>(w), static_cast<int8_t*>(q), static_cast<float*>(scale),
      static_cast<bool*>(dirty), static_cast<uint32_t*>(h1), static_cast<uint32_t*>(h2), blk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).

int ckpt_delta_encode_digest(const void* x, const void* prev, const void* w, void* q,
                             void* scale, void* dirty, void* h1, void* h2, long long nblk,
                             int blk, void* stream) {
  return launch_encode<true>(x, prev, w, q, scale, dirty, h1, h2, nblk, blk, stream);
}

int ckpt_delta_encode(const void* x, const void* prev, void* q, void* scale, void* dirty,
                      long long nblk, int blk, void* stream) {
  return launch_encode<false>(x, prev, nullptr, q, scale, dirty, nullptr, nullptr, nblk, blk,
                              stream);
}

int ckpt_bf16_encode_digest(const void* x, const void* w, void* y, void* h1, void* h2,
                            long long nblk, int blk, void* stream) {
  bf16_encode_digest_kernel<<<static_cast<unsigned>(nblk), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(w),
      static_cast<uint16_t*>(y), static_cast<uint32_t*>(h1), static_cast<uint32_t*>(h2), blk);
  return static_cast<int>(cudaGetLastError());
}

int ckpt_delta_decode(const void* q, const void* scale, const void* prev, void* out,
                      long long nblk, int blk, void* stream) {
  delta_decode_kernel<<<static_cast<unsigned>(nblk), kDecodeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(prev), static_cast<float*>(out), blk);
  return static_cast<int>(cudaGetLastError());
}

int ckpt_digest_blocks(const void* x, const void* w, void* out, long long n,
                       long long nblk, int blk, int bf16, void* stream) {
  const unsigned grid = static_cast<unsigned>((nblk + kDigestGroup - 1) / kDigestGroup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wu = static_cast<const uint32_t*>(w);
  auto* o = static_cast<uint32_t*>(out);
  if (bf16) {
    digest_blocks_kernel<true><<<grid, kThreads, 0, s>>>(x, wu, o, n, nblk, blk);
  } else {
    digest_blocks_kernel<false><<<grid, kThreads, 0, s>>>(x, wu, o, n, nblk, blk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ckpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
