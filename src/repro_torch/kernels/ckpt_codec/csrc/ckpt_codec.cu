// Checkpoint codec kernels for Hopper (sm_90a): the port of the Pallas
// kernels in src/repro/kernels/ckpt_codec/ckpt_codec.py.
//
//   K1 delta_encode_kernel<true>   <- delta_encode_digest_pallas (_encode_digest_kernel)
//   K2 bf16_encode_digest_kernel   <- bf16_encode_digest_pallas  (_bf16_digest_kernel)
//   K3 delta_decode_kernel         <- delta_decode_pallas        (_decode_kernel)
//   K4 delta_encode_kernel<false>  <- delta_encode_pallas        (_encode_kernel)
//   K5 digest_leaves_kernel        <- digest_blocks_pallas       (_digest_kernel)
//
// Data layout (K1-K4): [nblk, blk] row-major, one codec block (16384 fp32 on
// the main path) per CTA, as the Pallas grid had one block per grid step.
// blk must be a multiple of 4 and every pointer 16-byte aligned (checked by
// the Python wrapper), so all traffic is 16-byte vector loads and stores.
// K5 takes a list of flat leaves and a grid sized to the card (its note).
//
// Bound: K1-K4 stream device memory once and do a handful of operations
// per element (~9 B/element for K1, K3, K4; 6 B for K2), so they are bound
// by HBM bandwidth; K5's note weighs its bytes against its integer work.
// K1/K4 keep the block's delta (64 KiB) in dynamic shared memory between
// the amax pass and the quantize pass, so x and prev are read from HBM once.
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
//     and order-independent, so any reduction tree (and K5's atomic adds, in
//     any order) gives the same bits.
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

// K5: for each leaf of a list, per block of blk positions, two lanes
// sum(bits(fp32(x_i)) * w_k[i]) mod 2^32 over the raw block -- the
// digest-only sweep of the Pallas kernel -- and, in the same pass, the
// pre-dump classifier's second pair over fmix32(bits + w_0[i]) (see
// ref.mixed_lanes_ref: the raw lanes are linear in the bits, so a change
// that is uniform over a block, such as x -> 2x or x -> -x, can cancel in
// them). A leaf is a flat fp32 or bf16 buffer of n elements; its block b
// covers [b*blk, (b+1)*blk), elements past n count as zero (the zero
// padding of ops.digest_blocks: they add nothing to h1, h2 and
// fmix32(w_0[i]) * w_k[i] to g1, g2), an empty leaf is one zero block, and
// bf16 widens by bits << 16, the exact fp32 cast of the Pallas kernel.
// Leaf l's lanes are columns [col0_l, col0_l + nblk_l) of one [4, total]
// uint32 output, which the entry point zeroes before the launch.
//
// What bounds it. The function reads each input byte once: 4 B an fp32
// element, 2 B a bf16 one, 0.31 or 0.16 clocks an element of an SM's
// share of 3.35 TB/s at 1.98 GHz. Its integer work per element is one
// add, fmix32 (3 shifts, 3 xors, 2 multiplies) and four multiply-adds:
// 6 IMADs on the FMA pipe and 7 operations on the ALU pipe (+1 to widen a
// bf16), each pipe 64 lanes a clock an SM, one warp instruction issued a
// clock per sub-partition (128 lanes an SM). The built main loops
// (scripts/torch_k5_variants.py, cuobjdump -sass) spend 15.3 instructions
// an fp32 element (ALU 6.9, IMAD 7.1) and 16.2 a bf16 one (ALU 7.5, IMAD
// 7.4), loads, the per-block reduction and addressing included: 0.119 and
// 0.126 clocks an element of issue. Both dtypes are bound by bytes, fp32
// with the issue at 38% of the memory time, bf16 at 81%, so the bf16
// sweep needs nearly every issue slot the loads leave it. (The parent
// kernel spent 19.3 and 17.3.)
//
// The design follows from that.
//  - The grid is sized to the card (its SMs x the CTAs that fit one), not
//    to a leaf. A CTA owns one 1024-position slice of the block (blk /
//    1024 slices) for the whole launch, and its 8 warps are 8 streams:
//    block j of the list goes to stream j mod streams, whichever leaf it
//    is in. So one launch digests a whole tree, and a leaf of any size
//    spreads over blk / 1024 CTAs a block.
//  - The CTA reads its slice of both weight rows (8 KiB) into shared
//    memory once and never again: the weight table's L2 traffic is 8 KiB a
//    CTA a launch (the parent's CTAs of four blocks reread all 128 KiB,
//    half of x's bytes in fp32 and all of them in bf16), and the registers
//    go to loads in flight: 64 a thread, so 4 CTAs (32 warps) an SM, 128
//    KiB of fp32 loads in flight on each (3 CTAs at 80 registers ran the
//    fp32 sweep as fast and the bf16 one 3-6% slower back to back).
//  - A thread owns 32 positions as 16-byte runs (8 runs of 4 fp32, 4 of 8
//    bf16; a warp's runs side by side), loaded with streaming loads
//    (__ldcs) before any of them is digested: 128 B (fp32) or 64 B (bf16)
//    a thread in flight, and the per-block reduction spread over 32
//    elements.
//  - Partial lanes are combined exactly: uint32 wraparound sums are
//    exact in any order, so each warp reduces its 4 lanes across its 32
//    threads (a reduce-scatter: 6 shuffles, not 20) and four threads add
//    them into the output with one atomicAdd each; the entry point zeroes
//    the output on the stream first.
//  - A leaf's last block, if ragged, reads its elements one at a time in
//    place; whole blocks take the unmasked loop.
constexpr int kDigestThreads = 256;
constexpr int kDigestWarps = kDigestThreads / 32;
constexpr int kSlice = 1024;        // positions a CTA owns in every block
constexpr int kOwn = kSlice / 32;   // positions a thread owns: 32
constexpr int kParamLeaves = 128;   // leaves passed in the kernel's parameters

// The list of leaves when it fits the kernel's parameters (3 KiB); a longer
// list is read from the wrapper's device copy of the same int64 [L, 3] rows.
struct LeafTable {
  unsigned long long x[kParamLeaves];  // data pointer, | 1 for bf16
  long long n[kParamLeaves];           // elements
  long long col0[kParamLeaves];        // first output column
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// One unit u (an fp32 bit pattern) at a position of weights w0, w1.
__device__ __forceinline__ void digest_unit(uint32_t u, uint32_t w0, uint32_t w1,
                                            uint32_t (&acc)[4]) {
  const uint32_t m = fmix32(u + w0);
  acc[0] += u * w0;
  acc[1] += u * w1;
  acc[2] += m * w0;
  acc[3] += m * w1;
}

// Adds the warp's four partial lanes to column col: halve the values held
// per lane twice (offsets 16 and 8), then sum the one left over the 8
// lanes that hold it. Lanes 0, 8, 16, 24 then hold the warp's h1, h2, g1,
// g2 and add them to their row of the output (row: this lane's row).
__device__ __forceinline__ void warp_add_lanes(const uint32_t (&acc)[4], uint32_t* row,
                                               long long col) {
  const int lane = threadIdx.x & 31;
  const bool hi = lane & 16, mid = lane & 8;
  uint32_t k0 = hi ? acc[2] : acc[0], k1 = hi ? acc[3] : acc[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 16);
  uint32_t v = mid ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if ((lane & 7) == 0) atomicAdd(row + col, v);
}

// A thread's 32 positions of the CTA's slice in one block, as 16-byte
// loads: runs of 4 fp32 or 8 bf16 elements, a warp's 32 runs side by side
// (512 contiguous bytes a load instruction), kStride positions apart.
template <bool kBf16>
struct Own {
  static constexpr int kEs = kBf16 ? 2 : 4;
  static constexpr int kLen = 16 / kEs;        // elements a run
  static constexpr int kRuns = kOwn / kLen;    // 4 (bf16) or 8 (fp32)
  static constexpr int kStride = 32 * kLen;    // positions between runs
  uint4 q[kRuns];

  static __device__ __forceinline__ int first(int lane) { return kLen * lane; }

  __device__ __forceinline__ void load(const char* at) {  // at: position first(lane)
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      q[r] = __ldcs(reinterpret_cast<const uint4*>(at + kEs * kStride * r));
  }

  // ws0, ws1: the slice's two weight rows in shared memory
  __device__ __forceinline__ void digest(const uint32_t* ws0, const uint32_t* ws1, int lane,
                                         uint32_t* row, long long col) const {
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int pos = first(lane) + kStride * r;
      const uint32_t u[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
      for (int h = 0; h < kLen; h += 4) {  // 4 positions a pair of shared loads
        const uint4 a = *reinterpret_cast<const uint4*>(ws0 + pos + h);
        const uint4 c = *reinterpret_cast<const uint4*>(ws1 + pos + h);
        const uint32_t w0[4] = {a.x, a.y, a.z, a.w}, w1[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t x;
          if constexpr (kBf16) {  // little endian: the lower element is the low half
            const uint32_t word = u[(h + e) >> 1];
            x = (e & 1) ? word & 0xFFFF0000u : word << 16;
          } else {
            x = u[e];
          }
          digest_unit(x, w0[e], w1[e], acc);
        }
      }
    }
    warp_add_lanes(acc, row, col);
  }
};

// The whole blocks in columns [j, end) of one leaf that this warp's stream
// takes (j, j + streams, ...). Returns the first column past end on the
// stream.
template <bool kBf16>
__device__ __forceinline__ long long whole_blocks(const char* x, long long col0, long long end,
                                                  long long j, int streams, int blk, int s0,
                                                  int lane, const uint32_t* ws0,
                                                  const uint32_t* ws1, uint32_t* row) {
  using O = Own<kBf16>;
  if (j >= end) return j;
  const char* at = x + ((j - col0) * blk + s0 + O::first(lane)) * O::kEs;
  const long long step = static_cast<long long>(streams) * blk * O::kEs;
  for (; j < end; j += streams, at += step) {
    O own;
    own.load(at);
    own.digest(ws0, ws1, lane, row, j);
  }
  return j;
}

// A leaf's ragged last block (rem < blk elements left, 0 for an empty
// leaf): the thread's positions s0 + 4 lane + 128 r + e (r < 8, e < 4),
// each element read on its own, those past rem zero.
__device__ __forceinline__ void ragged_block(const char* xb, bool bf16, long long rem, int s0,
                                             int lane, const uint32_t* ws0, const uint32_t* ws1,
                                             uint32_t* row, long long col) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
  for (int k = 0; k < kOwn; ++k) {
    const int pos = 4 * lane + 128 * (k >> 2) + (k & 3);
    const long long p = s0 + pos;
    const uint32_t u = p >= rem ? 0u
                       : bf16   ? static_cast<uint32_t>(
                                    reinterpret_cast<const uint16_t*>(xb)[p]) << 16
                                : reinterpret_cast<const uint32_t*>(xb)[p];
    digest_unit(u, ws0[pos], ws1[pos], acc);
  }
  warp_add_lanes(acc, row, col);
}

__global__ void __launch_bounds__(kDigestThreads, 4)
    digest_leaves_kernel(const __grid_constant__ LeafTable tab,
                         const long long* __restrict__ rows, int nleaves,
                         const uint32_t* __restrict__ w, uint32_t* __restrict__ out,
                         long long total, int blk, int streams) {
  __shared__ __align__(16) uint32_t sw[2][kSlice];  // the slice's weights, 8 KiB
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = blk / kSlice;
  const int s0 = static_cast<int>(blockIdx.x % slices) * kSlice;
  // read once for the whole launch
  for (int i = threadIdx.x; i < kSlice / 4; i += kDigestThreads) {
    reinterpret_cast<uint4*>(sw[0])[i] = __ldg(reinterpret_cast<const uint4*>(w + s0) + i);
    reinterpret_cast<uint4*>(sw[1])[i] = __ldg(reinterpret_cast<const uint4*>(w + blk + s0) + i);
  }
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x / slices) * kDigestWarps + warp;
  if (g >= streams) return;  // the last CTAs may hold idle warps
  uint32_t* row = out + ((lane >> 3) & 3) * total;  // lanes 0, 8, 16, 24 add rows 0-3

  auto leaf = [&](int i, unsigned long long& x, long long& n, long long& c0) {
    if (rows) {
      x = static_cast<unsigned long long>(rows[3 * i]);
      n = rows[3 * i + 1];
      c0 = rows[3 * i + 2];
    } else {
      x = tab.x[i];
      n = tab.n[i];
      c0 = tab.col0[i];
    }
  };
  long long j = g;
  unsigned long long xa = 0;
  long long n = 0, c0 = 0;
  leaf(0, xa, n, c0);
  for (int i = 0; i < nleaves && j < total; ++i) {
    unsigned long long xn = 0;
    long long nn = 0, c1 = total;
    if (i + 1 < nleaves) leaf(i + 1, xn, nn, c1);
    if (j < c1) {
      const bool bf16 = xa & 1ull;
      const char* x = reinterpret_cast<const char*>(xa & ~1ull);
      const long long whole_end = c0 + n / blk;
      j = bf16 ? whole_blocks<true>(x, c0, whole_end, j, streams, blk, s0, lane, sw[0], sw[1],
                                    row)
               : whole_blocks<false>(x, c0, whole_end, j, streams, blk, s0, lane, sw[0], sw[1],
                                     row);
      for (; j < c1; j += streams) {
        const long long b = j - c0;
        ragged_block(x + b * blk * (bf16 ? 2 : 4), bf16, n - b * blk, s0, lane, sw[0], sw[1],
                     row, j);
      }
    }
    xa = xn;
    n = nn;
    c0 = c1;
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

// K5 over a list of leaves in one launch. table: host int64 [nleaves, 3]
// rows (data pointer | 1 for bf16, elements, first output column); rows:
// a device copy of them, read when nleaves > kParamLeaves (else null);
// out: [4, total] uint32, zeroed here on the stream before the launch; blk
// a multiple of 1024.
int ckpt_digest_leaves(const long long* table, int nleaves, const void* rows, const void* w,
                       void* out, long long total, int blk, void* stream) {
  if (nleaves <= 0 || total <= 0 || blk <= 0 || blk % kSlice ||
      (nleaves > kParamLeaves && rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static int cached_sms[64], cached_occ[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = dev < 64 ? cached_sms[dev] : 0, occ = dev < 64 ? cached_occ[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, digest_leaves_kernel,
                                                        kDigestThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) {
      cached_sms[dev] = sms;
      cached_occ[dev] = occ;
    }
  }
  // a CTA owns one slice of the block and 8 streams: a group of `slices`
  // CTAs covers whole blocks, and as many groups run as fit the card
  const int slices = blk / kSlice;
  long long groups = static_cast<long long>(sms) * (occ > 0 ? occ : 1) / slices;
  if (groups < 1) groups = 1;
  long long streams = groups * kDigestWarps;
  if (streams > total) streams = total;
  groups = (streams + kDigestWarps - 1) / kDigestWarps;
  const unsigned grid = static_cast<unsigned>(groups * slices);
  LeafTable local{};
  if (nleaves <= kParamLeaves) {
    for (int i = 0; i < nleaves; ++i) {
      local.x[i] = static_cast<unsigned long long>(table[3 * i]);
      local.n[i] = table[3 * i + 1];
      local.col0[i] = table[3 * i + 2];
    }
  }
  e = cudaMemsetAsync(out, 0, 4 * sizeof(uint32_t) * static_cast<size_t>(total),
                      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  digest_leaves_kernel<<<grid, kDigestThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      local, nleaves > kParamLeaves ? static_cast<const long long*>(rows) : nullptr, nleaves,
      static_cast<const uint32_t*>(w), static_cast<uint32_t*>(out), total, blk,
      static_cast<int>(streams));
  return static_cast<int>(cudaGetLastError());
}

const char* ckpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
