// Flash attention forward for Hopper (sm_90a): the port of the Pallas kernel
// flash_attention_fwd (_kernel) in src/repro/kernels/flash_attention/flash_attention.py.
//
// What it computes, as the Pallas kernel does:
//   q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (KV divides H); query row i sits at
//   position q_off + i with q_off = Skv - Sq; head h reads kv head h / (H/KV)
//   (GQA without a repeat); s = (fp32(q) * fl32(hd^-0.5)) . fp32(k) in fp32;
//   optional softcap * tanh(s / softcap); causal (qpos >= kpos) and window
//   (qpos - kpos < window) masks set s to -1e30; online softmax with the
//   running max floored at -1e9; p is rounded to v's dtype before the PV
//   product, which accumulates in fp32; out = acc / max(l, 1e-20), cast to
//   q's dtype. Any Sq <= Skv: the ragged last q and kv tiles are masked by
//   position.
//
// Design. One CTA per (query tile of 64 rows, b*H + h); 256 threads as 16 row
// groups of 4 rows x 16 lanes. A loop over key tiles of 64 takes the place of
// the Pallas kernel's sequential kv grid axis; tiles that the causal or window
// mask empties entirely are never visited. Per key tile: K (transposed) and V
// are staged in shared memory in their own dtype, the 4x4 score micro-tile of
// each thread is summed with fp32 FMAs over hd, the row max and row sum are
// reduced across the 16 lanes of a half-warp with shuffles, p goes through
// shared memory (transposed) and each thread accumulates a 4 x hd/16 slice of
// the output in registers. Query tiles are launched heaviest first (the last
// causal tiles see the most keys). No atomics: every sum has a fixed order,
// so the same inputs give the same bits on every run.
//
// Bound: at the serving shape (bf16, B=4, S=2048, H=32, KV=8, hd=128) the
// causal work is ~137 GFLOP against ~170 MB of inputs and outputs, so the
// card's bound is its bf16 tensor-core rate (~0.14 ms). This first kernel
// multiplies in fp32 on the CUDA cores (the fp32 tolerance of 2e-6 rules out
// TF32, and bf16 inputs are exact in fp32), so it runs far from that bound;
// wgmma and TMA are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
        s[i][j] = D::load(D::store(p));  // p.astype(v.dtype)
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns cudaGetLastError() (0 on
// success). q, o: [B,Sq,H,hd]; k, v: [B,Skv,KV,hd]; contiguous, 16-byte
// aligned, all fp32 (bf16 == 0) or all bf16 (bf16 == 1); hd in {16, 32, 64, 128};
// Sq <= Skv; B*H < 65536.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int H, int KV, int hd, int bf16, int causal, int window,
                        float softcap, float scale, void* stream) {
  if (bf16) {
    return dispatch_hd<BF16>(hd, q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                             stream);
  }
  return dispatch_hd<F32>(hd, q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, softcap,
                          stream);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
