// Flash attention forward for Hopper (sm_90a): the port of the Pallas kernel
// flash_attention_fwd (_kernel) in src/repro/kernels/flash_attention/flash_attention.py.
//
// What it computes, as the Pallas kernel does:
//   q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (KV divides H); query row i sits at
//   position q_off + i with q_off = Skv - Sq; head h reads kv head h / (H/KV)
//   (GQA without a repeat); s = q . k * hd^-0.5 in fp32; optional
//   softcap * tanh(s / softcap); causal (qpos >= kpos) and window
//   (qpos - kpos < window) masks set s to -1e30; online softmax with the
//   running max floored at -1e9; the PV product accumulates in fp32;
//   out = acc / max(l, 1e-20), cast to q's dtype. Any Sq <= Skv: the ragged
//   last q and kv tiles are masked by position.
//
// The Pallas kernel upcasts v to fp32 before p.astype(v.dtype), so its p
// stays fp32. Both routes here round p to the inputs' dtype before the PV
// product, as the JAX package's xla_flash and reference_attention do: a
// no-op in fp32, a rounding to bf16 for bf16 inputs (and what a bf16
// tensor-core product needs).
//
// Two routes, chosen by the wrapper from dtype and head dim alone (no
// fallback at run time):
//
// * wgmma (bf16, hd 64, 128 and 256): flash_fwd_wgmma below, one instance
//   per head dim. Bound by operations (the card's bf16 tensor-core rate:
//   ~137 GFLOP of live causal pairs against ~170 MB at the serving shape,
//   ~0.14 ms; 85.9 GFLOP against 57 MB at gemma2's 4608-token prefill,
//   ~0.087 ms), so the products run on the tensor cores. One CTA per
//   (128-row query tile, b*H + h): two consumer warpgroups of 64 query rows
//   each and a producer. The producer loads the Q tile once and a ring of
//   K/V tiles of 64 keys with TMA (4-D tensor maps over [B, S, heads, hd],
//   so rows past S are zero-filled within the batch; 128B swizzle, a row as
//   hd/64 boxes of 64 columns), signalling full mbarriers per tile and
//   empty ones per K and per V slot. Each consumer warpgroup computes
//   S = Q K^T with wgmma.m64n64k16 from shared memory (fp32 accumulators),
//   scales, caps and masks S in registers (masks only on tiles that
//   straddle the diagonal, the window edge or Skv), runs the online softmax
//   over the 4 lanes of a quad, rounds p to bf16 in registers and adds P V
//   with wgmma.m64n{hd}k16, p as the register A operand (the accumulator
//   fragment of S is the A fragment's layout) and V as the MN-major shared
//   B operand. A warpgroup issues S_j and P_{j-1} V_{j-1} back to back and
//   runs the softmax of S_j while the second product runs; it frees K_j's
//   slot once S_j has landed and V_{j-1}'s once its product has, so the
//   copy of a tile overlaps a whole step. The two warpgroups take turns
//   issuing (named barriers), so one's products overlap the other's
//   softmax. Tiles the masks empty for the whole CTA are never loaded;
//   query tiles go heaviest first.
//   Per head dim (Cfg, Smem): at 64 and 128 a 3-stage ring and a producer
//   warp (288 threads). At 256 (gemma2) the Q tile is 64 KB and a K/V
//   stage 64 KB, so the ring has 2 stages (192 KB with Q, under the
//   232,448-byte limit); a thread holds 128 fp32 O accumulators, 32 of S
//   and 16 bf16 pairs of P across the overlapped step, more than the 224
//   registers 288 threads may each take (ptxas spills there), so the
//   producer is a whole warpgroup (384 threads) that gives its registers
//   to the consumers with setmaxnreg (24 for the producer, 240 for each
//   consumer thread), and P V is one wgmma.m64n256k16.
//   Its deviations from the Pallas kernel: the scale is applied to the fp32
//   product (the Pallas kernel scales q first; the bf16 products are exact,
//   so only the rounding of the sums differs); p is rounded to bf16
//   (above); the sums are taken in tensor-core order; exp2 with log2(e)
//   folded into the scale, the running max and its -1e9 floor kept in log2
//   units; the softcap is computed as cap - 2 cap / (e^(2 s / cap) + 1)
//   with ex2.approx and rcp.approx (within ~1e-6 of tanhf; __fdiv_rn and
//   tanhf took about half the kernel's time at gemma2's prefill).
//
// * SIMT (fp32 at every head dim, bf16 at hd 16 and 32): flash_fwd_kernel.
//   The fp32 tolerance of 2e-6 rules out TF32 and bf16 tensor cores, so it
//   multiplies in fp32 on the CUDA cores (bf16 inputs are exact in fp32),
//   in the Pallas kernel's order (q scaled first). One CTA per (query tile
//   of 64 rows, b*H + h); 256 threads as 16 row groups of 4 rows x 16
//   lanes. A loop over key tiles of 64 takes the place of the Pallas
//   kernel's sequential kv grid axis; tiles that the causal or window mask
//   empties entirely are never visited. Per key tile: K (transposed) and V
//   are staged in shared memory in their own dtype, the 4x4 score
//   micro-tile of each thread is summed with fp32 FMAs over hd, the row max
//   and row sum are reduced across the 16 lanes of a half-warp with
//   shuffles, p goes through shared memory (transposed) and each thread
//   accumulates a 4 x hd/16 slice of the output in registers. Query tiles
//   are launched heaviest first. At hd 256 a thread holds 64 fp32
//   accumulators, and the fp32 tiles take 214,016 bytes of shared memory
//   (one CTA per SM), under the 232,448-byte opt-in limit.
//
// Neither route uses atomics or splits the kv axis: every sum has a fixed
// order, so the same inputs give the same bits on every run.
#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // 16 row groups x 16 lanes
constexpr int PST = BK + 4;   // row stride of the transposed p tile (floats)
constexpr float kNeg = -1e30f;
constexpr float kMFloor = -1e9f;

struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S x) { return x; }
  static __device__ __forceinline__ S store(float x) { return x; }
};

struct BF16 {  // bit patterns; conversions are exact (load) or round to nearest even
  using S = uint16_t;
  static __device__ __forceinline__ float load(S x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  static __device__ __forceinline__ S store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <int NB> struct Word;  // an NB-byte load/store unit
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };

// N consecutive elements (N * sizeof(S) bytes, aligned to that size) -> fp32
template <class D, int N>
__device__ __forceinline__ void load_n(const typename D::S* p, float* out) {
  using S = typename D::S;
  constexpr int NB = N * static_cast<int>(sizeof(S));
  constexpr int WB = NB >= 16 ? 16 : NB;
  constexpr int PER = WB / static_cast<int>(sizeof(S));
  using W = typename Word<WB>::T;
#pragma unroll
  for (int w = 0; w < NB / WB; ++w) {
    union {
      W u;
      S e[PER];
    } pk;
    pk.u = reinterpret_cast<const W*>(p)[w];
#pragma unroll
    for (int e = 0; e < PER; ++e) out[w * PER + e] = D::load(pk.e[e]);
  }
}

template <class D, int N>
__device__ __forceinline__ void store_n(typename D::S* p, const float* in) {
  using S = typename D::S;
  constexpr int NB = N * static_cast<int>(sizeof(S));
  constexpr int WB = NB >= 16 ? 16 : NB;
  constexpr int PER = WB / static_cast<int>(sizeof(S));
  using W = typename Word<WB>::T;
#pragma unroll
  for (int w = 0; w < NB / WB; ++w) {
    union {
      W u;
      S e[PER];
    } pk;
#pragma unroll
    for (int e = 0; e < PER; ++e) pk.e[e] = D::store(in[w * PER + e]);
    reinterpret_cast<W*>(p)[w] = pk.u;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

template <class D, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * HD * BQ                    // Qt: q * scale, [HD][BQ]
         + 2 * sizeof(typename D::S) * HD * BK      // Kt [HD][BK], Vs [BK][HD]
         + sizeof(float) * BK * PST;                // Pt: p, [BK][PST]
}

template <class D, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const typename D::S* __restrict__ q, const typename D::S* __restrict__ k,
                     const typename D::S* __restrict__ v, typename D::S* __restrict__ o, int Sq,
                     int Skv, int H, int KV, float scale, int causal, int window, float softcap) {
  using S = typename D::S;
  constexpr int VN = 16 / static_cast<int>(sizeof(S));  // elements per 16-byte vector
  constexpr int NCH = HD / VN;                           // vectors per row
  constexpr int DPT = HD / 16;                           // output columns per thread

  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  S* Kt = reinterpret_cast<S*>(Qt + HD * BQ);
  S* Vs = Kt + HD * BK;
  float* Pt = reinterpret_cast<float*>(Vs + BK * HD);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_off = Skv - Sq;
  const int q0 = qt * BQ;
  const size_t qstride = static_cast<size_t>(H) * HD;  // elements between rows
  const size_t kstride = static_cast<size_t>(KV) * HD;
  const S* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const S* kb = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const S* vb = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  S* ob = o + (static_cast<size_t>(b) * Sq * H + h) * HD;

  // q tile -> Qt, upcast and scaled in fp32; rows past Sq are zero
  for (int it = tid; it < BQ * NCH; it += NT) {
    const int r = it % BQ, c = it / BQ;
    float x[VN];
    if (q0 + r < Sq) {
      load_n<D, VN>(qb + static_cast<size_t>(q0 + r) * qstride + c * VN, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) Qt[(c * VN + e) * BQ + r] = __fmul_rn(x[e], scale);
  }

  // the key tiles this query tile can see
  const int q_lo = q_off + q0, q_hi = q_lo + BQ - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  const int k_begin = window ? max(0, q_lo - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Qt written; the previous tile's Kt/Vs/Pt readers are done
    for (int it = tid; it < BK * NCH; it += NT) {  // K tile, transposed
      const int r = it % BK, c = it / BK;
      union {
        uint4 u;
        S e[VN];
      } pk;
      pk.u = k0 + r < Skv
                 ? *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(k0 + r) * kstride +
                                                   c * VN)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < VN; ++e) Kt[(c * VN + e) * BK + r] = pk.e[e];
    }
    for (int it = tid; it < BK * NCH; it += NT) {  // V tile, as stored
      const int r = it / NCH, c = it % NCH;
      const uint4 u =
          k0 + r < Skv
              ? *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(k0 + r) * kstride + c * VN)
              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Vs + r * HD + c * VN) = u;
    }
    __syncthreads();

    // scores of rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      float kk[4];
      load_n<D, 4>(Kt + d * BK + tx * 4, kk);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float x = s[i][j];
        if (softcap != 0.0f) x = __fmul_rn(tanhf(__fdiv_rn(x, softcap)), softcap);
        bool ok = kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && qp - kp < window;
        s[i][j] = ok ? x : kNeg;
      }
    }

    // online softmax: the 16 lanes of a half-warp share rows ty*4..ty*4+3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, kMFloor);
      const float corr = expf(fmaxf(m[i], kMFloor) - m_safe);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        s[i][j] = D::load(D::store(p));  // p rounded to the inputs' dtype
      }
      rs = half_warp_sum(rs);
      l[i] = __fmaf_rn(l[i], corr, rs);
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * PST + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p . v over this tile's keys
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * PST + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[DPT];
      load_n<D, DPT>(Vs + c * HD + tx * DPT, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = __fmaf_rn(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float out[DPT];
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) out[jj] = __fdiv_rn(acc[i][jj], den);
    store_n<D, DPT>(ob + static_cast<size_t>(r) * qstride + tx * DPT, out);
  }
}

template <class D, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int KV, float scale, int causal, int window, float softcap, void* stream) {
  using S = typename D::S;
  constexpr size_t smem = smem_bytes<D, HD>();
  static_assert(smem <= 232448, "over the sm_90 opt-in shared memory per block");
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D, HD><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<S*>(o), Sq, Skv, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                int Skv, int H, int KV, float scale, int causal, int window, float softcap,
                void* stream) {
  switch (hd) {
    case 16:
      return launch<D, 16>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    case 32:
      return launch<D, 32>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    case 64:
      return launch<D, 64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    case 128:
      return launch<D, 128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    case 256:
      return launch<D, 256>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ------------------------------------------------------------------ wgmma route
namespace wg {

constexpr int BQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int BK = 64;           // keys per tile
constexpr int NCONS = 256;       // consumer threads
constexpr int BOX = 64;          // columns per TMA box: 128 bytes, the 128B swizzle's width
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  // K/V ring depth: at 256 a stage is 64 KB (K and V tiles of 32 KB), and
  // the 64 KB Q tile leaves room for two
  static constexpr int ST = HD == 256 ? 2 : 3;
  // the producer: one warp, or at 256 a whole warpgroup, so that setmaxnreg
  // can hand its registers to the consumers (128 x 24 + 256 x 240 <= 65,536)
  static constexpr int NPROD = HD == 256 ? 128 : 32;
  static constexpr int NT = NCONS + NPROD;
};

template <int HD>
struct Smem {                                    // byte offsets from a 1024-aligned base
  static constexpr int ST = Cfg<HD>::ST;
  static constexpr int NH = HD / BOX;            // 64-column blocks of a row
  static constexpr int Q = 0;                    // [NH][BQ][64] bf16
  static constexpr int K = Q + NH * BQ * BOX * 2;    // [ST][NH][BK][64]
  static constexpr int V = K + ST * NH * BK * BOX * 2;
  static constexpr int BAR = V + ST * NH * BK * BOX * 2;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * ST);  // full_q; full and empty of K and V
  static constexpr uint32_t KV_TILE_BYTES = NH * BK * BOX * 2;   // one K (or V) tile
  static constexpr uint32_t Q_BYTES = NH * BQ * BOX * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map (coordinates innermost first) -> shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile whose rows are 128
// bytes: start address >> 4, LBO (16-byte units: the stride between 64-column
// blocks; read only for an MN-major operand wider than 64), SBO = 1024 bytes
// between 8-row groups, layout 1 = 128B swizzle. Tile bases are 1024-aligned,
// so the base offset is 0; a k-step inside a 64-column block moves the start
// address by 32 bytes (K-major) and the hardware applies the swizzle to the
// resulting addresses.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // returns once at most N committed groups are still in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// named barriers 1 and 2, over the two consumer warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(NCONS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(NCONS) : "memory");
}

// keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[0:32] (+)= A[64x16] (shared, K-major) . B[64x16]^T (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] += A[64x16] (registers, bf16) . B[16x64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[0:64] += A[64x16] (registers, bf16) . B[16x128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[0:128] += A[64x16] (registers, bf16) . B[16x256] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int HD>
struct PV;  // O[64 x HD] += P[64 x 16] . V[16 x HD]
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};
template <>
struct PV<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n256(d, a, db);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per (128-row query tile, b*H + h). Step j of a consumer warpgroup
// issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} back to back, so its softmax
// of S_j overlaps its own P V product; named barriers 1 and 2 make the two
// warpgroups take turns issuing, so one's products run while the other
// computes its softmax. K_j's slot is freed once S_j has landed and V_j's
// once its product has, so with two stages the copies of K_{j+2} and V_{j+1}
// run during step j + 1.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, uint16_t* __restrict__ o, int Sq,
                    int Skv, int H, int KV, float scale, float scale_log2, int causal, int window,
                    float softcap) {
  using L = Smem<HD>;
  constexpr int NH = L::NH, ST = L::ST;
  constexpr int NO = HD / 2;  // O accumulator registers per thread
  constexpr int NS = BK / 2;  // S accumulator registers per thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* Qs = reinterpret_cast<uint16_t*>(base + L::Q);
  uint16_t* Ks = reinterpret_cast<uint16_t*>(base + L::K);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(base + L::V);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int q_off = Skv - Sq;

  // the key tiles [t0, t1) that query rows [r0, r1) can see
  auto tiles = [&](int r0, int r1, int& t0, int& t1) {
    const int lo = q_off + r0, hi = q_off + r1 - 1;
    const int k_end = causal ? min(Skv, hi + 1) : Skv;
    const int k_begin = window ? max(0, lo - window + 1) : 0;
    t0 = k_begin / BK;
    t1 = k_begin < k_end ? (k_end + BK - 1) / BK : t0;
  };
  int t_begin, t_end;
  tiles(q0, min(q0 + BQ, Sq), t_begin, t_end);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, NCONS / 32);  // one arrival per consumer warp
      mbar_init(empty_v + s, NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {  // the producer: one lane issues every copy
    if constexpr (Cfg<HD>::NPROD == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == NCONS / 32 && lane == 0) {
      mbar_expect_tx(full_q, L::Q_BYTES);
      for (int c = 0; c < NH; ++c) tma_load(Qs + c * BQ * BOX, &tq, full_q, c * BOX, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % ST, r = i / ST;
        if (r > 0) mbar_wait(empty_k + s, (r - 1) & 1);
        // the full box bytes, also where TMA zero-fills rows past Skv
        mbar_expect_tx(full_k + s, L::KV_TILE_BYTES);
        for (int c = 0; c < NH; ++c)
          tma_load(Ks + (s * NH + c) * BK * BOX, &tk, full_k + s, c * BOX, kvh, t * BK, b);
        if (r > 0) mbar_wait(empty_v + s, (r - 1) & 1);
        mbar_expect_tx(full_v + s, L::KV_TILE_BYTES);
        for (int c = 0; c < NH; ++c)
          tma_load(Vs + (s * NH + c) * BK * BOX, &tv, full_v + s, c * BOX, kvh, t * BK, b);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64g ...; this thread holds,
  // in every accumulator, rows wr + 16w + lane/4 (+8) and column pairs
  // 8j + 2(lane%4) (the wgmma D fragment). Both warpgroups walk every tile
  // of the CTA (the masks empty what a warpgroup's rows cannot see), so
  // their turns pair up and no wgmma sits in a divergent branch.
  if constexpr (Cfg<HD>::NPROD == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int g = warp >> 2, w = warp & 3;
  const int cq = (lane & 3) * 2;
  const int wr = q0 + 64 * g;
  const int wq_lo = q_off + wr, wq_hi = q_off + wr + 63;
  const int row0 = wr + 16 * w + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int qp0 = q_off + row0;
  const int n = t_end - t_begin;

  float oacc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) oacc[j] = 0.0f;
  float sacc[NS];
  uint32_t pf[NS / 2];  // P rounded to bf16: the A fragments of its BK/16 k-steps
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};            // this thread's part of the row sums
  const uint32_t q_base = smem_u32(Qs) + g * 64 * BOX * 2;
  // the cap as softcap - 2 softcap / (e^(2 s / softcap) + 1): two MUFU ops
  // (ex2, rcp) and three FP32 ops a score
  const float cap_e = softcap != 0.0f ? 2.0f * kLog2e * scale / softcap : 0.0f;
  const float cap_l = softcap * kLog2e, cap_m2 = -2.0f * cap_l;

  auto issue_s = [&](int j) {  // S_j = Q K_j^T; k-steps 0-3 read the first 64 columns
    const uint32_t k_base = smem_u32(Ks + (j % ST) * NH * BK * BOX);
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = 0.0f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // bytes into the 128-byte row
      wgmma_ss_n64(sacc, sw128_desc(q_base + (kk >> 2) * BQ * BOX * 2 + col, 16),
                   sw128_desc(k_base + (kk >> 2) * BK * BOX * 2 + col, 16), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P_j V_j, k-steps of 16 keys (2048 bytes of V rows)
    const uint32_t v_base = smem_u32(Vs + (j % ST) * NH * BK * BOX);
    fence_regs(oacc);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
      PV<HD>::mma(oacc, a, sw128_desc(v_base + kk * 16 * BOX * 2, BK * BOX * 2));
    }
    wgmma_commit();
  };
  // online softmax of S_j in place (sacc becomes p in fp32); returns in
  // corr the factor that rescales O and l to the new running max
  auto softmax = [&](int j, float (&corr)[2]) {
    fence_regs(sacc);
    const int k0 = (t_begin + j) * BK;
    // scale (log2 units), softcap, masks on tiles that straddle an edge;
    // one loop per case, so a tile without an edge or a cap runs none of
    // their instructions (a test inside the unrolled loop is predicated,
    // and its instructions issue on every tile)
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > wq_lo) ||
                      (window && k0 <= wq_hi - window);
    float mx[2] = {kNeg, kNeg};
    auto scores = [&](auto with_edge, auto with_cap) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sacc[i];
        if constexpr (decltype(with_cap)::value) {  // softcap * tanh(s / softcap)
          x = __fmaf_rn(rcp_approx(ex2(x * cap_e) + 1.0f), cap_m2, cap_l);
        } else {
          x *= scale_log2;
        }
        if constexpr (decltype(with_edge)::value) {
          const int kp = k0 + (i >> 2) * 8 + cq + (i & 1);
          const int qp = qp0 + ((i >> 1) & 1) * 8;
          bool ok = kp < Skv;  // TMA zero-filled the keys past Skv: s = 0 there, not -inf
          if (causal) ok = ok && qp >= kp;
          if (window) ok = ok && qp - kp < window;
          x = ok ? x : kNeg;
        }
        sacc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
    };
    using Y = std::true_type;
    using N = std::false_type;
    if (softcap != 0.0f) {
      if (edge) scores(Y{}, Y{}); else scores(N{}, Y{});
    } else {
      if (edge) scores(Y{}, N{}); else scores(N{}, N{});
    }
    float msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      float v = mx[r];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float m_new = fmaxf(m[r], v);
      msafe[r] = fmaxf(m_new, kMFloor);
      corr[r] = ex2(fmaxf(m[r], kMFloor) - msafe[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sacc[i] = ex2(sacc[i] - msafe[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], corr[r], rs[r]);
  };
  auto to_p = [&](const float (&corr)[2]) {  // P_j for the next product; O to the new max
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const __nv_bfloat162 pk = __floats2bfloat162_rn(sacc[i], sacc[i + 1]);
      pf[i >> 1] = *reinterpret_cast<const uint32_t*>(&pk);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= corr[(i >> 1) & 1];
  };
  auto release = [&](uint64_t* bar) {  // this warp is done with a K or V slot
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  mbar_wait(full_q, 0);
  if (g == 1) named_arrive(1);  // warpgroup 0 takes the first turn
  float corr[2];
  mbar_wait(full_k, 0);
  named_sync(1 + g);
  issue_s(0);
  named_arrive(2 - g);
  wgmma_wait<0>();
  release(empty_k);
  softmax(0, corr);
  to_p(corr);
  for (int j = 1; j < n; ++j) {  // S_j and P_{j-1} V_{j-1} back to back
    mbar_wait(full_k + j % ST, (j / ST) & 1);
    mbar_wait(full_v + (j - 1) % ST, ((j - 1) / ST) & 1);
    named_sync(1 + g);
    issue_s(j);
    issue_pv(j - 1);
    named_arrive(2 - g);
    wgmma_wait<1>();  // S_j has landed: K_j's slot is free
    release(empty_k + j % ST);
    softmax(j, corr);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pf);
    release(empty_v + (j - 1) % ST);
    to_p(corr);
  }
  mbar_wait(full_v + (n - 1) % ST, ((n - 1) / ST) & 1);
  named_sync(1 + g);
  issue_pv(n - 1);
  named_arrive(2 - g);
  wgmma_wait<0>();
  fence_regs(oacc);
  release(empty_v + (n - 1) % ST);
  if (g == 0) named_sync(1);  // warpgroup 1's last arrival

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float den = fmaxf(lt, 1e-20f);
    const int row = row0 + 8 * r;
    if (row < Sq) {
      uint16_t* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const __nv_bfloat162 pk = __floats2bfloat162_rn(__fdiv_rn(oacc[4 * j + 2 * r], den),
                                                        __fdiv_rn(oacc[4 * j + 2 * r + 1], den));
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = pk;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so the library needs no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &qr);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr);
#endif
    return e == cudaSuccess && qr == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// a contiguous [B, S, heads, hd] bf16 tensor as a 4-D map (hd, heads, S, B)
// with boxes of (64, 1, rows, 1): rows past S read as zeros, within the batch
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int KV, float scale, int causal, int window, float softcap, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, HD, BQ) || !make_map(&tk, k, B, Skv, KV, HD, BK) ||
      !make_map(&tv, v, B, Skv, KV, HD, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<HD>::BYTES + 1024;  // + room to align the base to 1024
  static_assert(smem <= 232448, "over the sm_90 opt-in shared memory per block");
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<HD><<<grid, Cfg<HD>::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), Sq, Skv, H, KV, scale, scale * kLog2e, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() (0 on success). q, o: [B,Sq,H,hd]; k, v: [B,Skv,KV,hd];
// contiguous, 16-byte aligned; Sq <= Skv; scale = hd^-0.5.

// SIMT route: all fp32 (bf16 == 0) with hd in {16, 32, 64, 128, 256}, or
// all bf16 (bf16 == 1) with hd in {16, 32} (bf16 at 64, 128 and 256 takes
// the wgmma route); B*H < 65536.
int flash_attention_fwd_simt(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                             int Skv, int H, int KV, int hd, int bf16, int causal, int window,
                             float softcap, float scale, void* stream) {
  if (!bf16) {
    return dispatch_hd<F32>(hd, q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                            stream);
  }
  switch (hd) {
    case 16:
      return launch<BF16, 16>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                              stream);
    case 32:
      return launch<BF16, 32>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// wgmma route: all bf16, hd in {64, 128, 256}. Fails with cudaErrorInvalidValue
// if the driver's tensor-map encoder is missing or refuses a map.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                              int Skv, int H, int KV, int hd, int causal, int window,
                              float softcap, float scale, void* stream) {
  switch (hd) {
    case 64:
      return wg::launch<64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap, stream);
    case 128:
      return wg::launch<128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                             stream);
    case 256:
      return wg::launch<256>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
