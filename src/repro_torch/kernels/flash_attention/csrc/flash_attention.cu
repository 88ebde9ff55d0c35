// flash_attention: blockwise online-softmax attention over grouped kv heads,
// for the models' (B, S, H, hd) layout.  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _attn_kernel) and computes the function of
// its oracle, ref.attention_ref: causal masking end-aligned to the keys
// (query row i sits at key position i + Skv - Sq), a sliding window (keys
// more than `window` - 1 behind a row are masked), tanh logit soft-capping
// (`softcap * tanh(s / softcap)` before the mask), grouped-query attention
// (query head h reads kv head h / (H / Hkv)), softmax statistics and
// accumulation in float32, masked logits at -1e30, the denominator clamped
// at 1e-30, the output in the inputs' type (float32 or bfloat16).  Every
// body takes any Sq <= Skv and reads q, k and v through their strides, so
// decode runs over a cache slice (Skv = pos + 1 valid rows) or a ring in
// place.  The plain PyTorch version is repro_torch/kernels/flash_attention/
// ref.py::attention_ref.
//
// Three bodies; kernel.py::plan names the one a call takes, from the shapes
// and the type alone (never as a fallback):
//
// * tc_prefill (bf16, head dim 64 / 128 / 256, Sq >= 64).  The prefill's
//   work is 137.5 GFLOP against 168 MB at the serving paths' shapes, so the
//   bound is the bf16 tensor-core rate (0.139 ms at 989 TFLOP/s); CUDA
//   cores in float32 (67 TFLOP/s) cannot come within 2 ms of it.  So both
//   products run on the tensor cores as warpgroup MMAs (wgmma, from the
//   port's shared kernels/csrc/hopper.cuh): a block of 384 threads owns
//   128 query rows of one head.  One thread of
//   the producer warpgroup issues TMA loads: the Q tile once, then K and V
//   tiles into a two-stage shared-memory ring guarded by mbarriers (full:
//   the bytes landed; empty: all 256 consumer threads are done with the
//   stage), 128-byte swizzled, which is the layout the wgmma descriptors
//   read.  Each of the two consumer warpgroups owns 64 query rows: S = Q K^T
//   as m64nBKVk16 products (both operands K-major in shared memory,
//   float32 accumulators), then in float32 registers the scale, the
//   soft-cap, the mask (built from each thread's fragment coordinates, only
//   on tiles that straddle the diagonal, the window edge or Skv) and the
//   online max and sum in the log2 domain (exp2f), then P packed to bf16 in
//   registers as the A operand of O += P V (V MN-major through the
//   descriptor's transpose bit), with no shared-memory round trip.  P in
//   bf16 is the one rounding the oracle does not make.  setmaxnreg moves
//   registers from the producer (40) to the consumers (232): the O
//   accumulator alone is HD / 2 floats a thread.  BKV = 128 keys at head
//   dims 64 and 128, 64 at 256 (192 KB of shared memory); one block per SM.
//   The grid is (H, B, q blocks), the q blocks with the most keys first, so
//   causal work balances; tiles no row of the block can see are never
//   loaded, and a warpgroup skips the products of tiles none of its rows
//   can see.
// * split_decode (both types, any head dim, Sq x group <= 64 rows: decode
//   steps and short prompts over a cache).  There the bound is the K/V bytes
//   (33.6 MB, 0.010 ms at Qwen3's decode shape; 8.4 MB over recurrentgemma's
//   ring), which a block per query head would read once per query head, from
//   as few as 64 blocks.  So one block per (kv split, kv head, batch row)
//   holds all `group` query heads' rows, each K/V byte is read once, and the
//   splits (kernel.py picks their count so the grid covers the card about
//   twice over, each a whole number of 64-key tiles) occupy every SM.  In bf16
//   at head dims 64 / 128 / 256 the rows are the first rows of one consumer
//   warpgroup's 64-row tile (the rest zeros) and the keys stream through the
//   same TMA ring and wgmma products as tc_prefill, in 64-key tiles: on CUDA
//   cores the logits' and P V's dependent chains, not the bytes, set the
//   time.  Float32 (the decode of a float32 compute dtype's serve), and bf16
//   at head dims 16 / 32, stay on CUDA cores (float32 at Qwen3's shape on an
//   H100: 0.047 ms of device time, against 0.020 ms for its 67 MB and 0.42
//   ms through fp32_prefill): K/V tiles stream through shared memory by
//   16-byte cp.async, two buffers deep; threads over keys for the logits, a
//   warp per row for the statistics, threads over (row, 4 columns) for P V,
//   all in float32, 16 rows a block.
//   Each split writes its unnormalised float32 partials (max, sum,
//   accumulator) to scratch the wrapper allocates; a second small kernel, a
//   block per output row, merges them in split order, so the result is bitwise
//   the same from run to run, with no atomics.
// * fp32_prefill (float32 prefill, and bf16 at head dims 16 / 32 or rows
//   that fill neither of the above).  TF32 cannot meet float32's 2e-5, so
//   float32 products stay on CUDA cores: one block of 256 threads owns
//   (b, h, 64 query rows) and loops over 32-key tiles; four threads share a
//   query row, each holding a quarter of its float32 accumulator in
//   registers and computing every fourth key's logit; the scaled Q block
//   and each K/V tile are staged in shared memory as float32 (rows padded
//   by 4 floats), the tile's probabilities pass through a small shared
//   array to the threads that own the output columns.
#include <math.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}


__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------- fp32_prefill
namespace fp32 {


constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per block
constexpr int KPT = BKV / TPR;   // keys per thread in a tile
constexpr int PST = BKV + 4;     // row stride of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (HD + 4) + (size_t)BKV * (HD + 4) +
          (size_t)BKV * HD + (size_t)BQ * PST);
}

template <int HD, typename T>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int group, int Sq,
    int Skv, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, float softcap, float scale) {
  constexpr int ST = HD + 4;        // row stride of the Q and K tiles
  constexpr int C4 = HD / 4;        // float4 chunks in a row
  constexpr int CPT = C4 / TPR;     // chunks a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ST;
  float* Vs = Ks + BKV * ST;
  float* Ps = Vs + BKV * HD;

  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_offset = Skv - Sq;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int idx = tid; idx < BQ * C4; idx += NT) {
    const int r = idx / C4, c = idx % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qb + (long long)(q0 + r) * qss + 4 * c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(Qs + r * ST + 4 * c, x);
  }

  // kv tiles that hold a key some row of this block can see
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, last_pos + 1) : Skv;
  const int kv_lo =
      window > 0 ? max(0, first_pos - window + 1) / BKV * BKV : 0;
  // whole warps (8 rows) past Sq only help stage the tiles
  const bool active = q0 + (row & ~7) < Sq;
  const int qpos = q0 + row + q_offset;

  float m_i = NEG_INF, l_i = 0.f;
  float4 acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BKV) {
    __syncthreads();   // the Q block is staged; the last tile is consumed
    for (int idx = tid; idx < BKV * C4; idx += NT) {
      const int r = idx / C4, c = idx % C4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kv0 + r < Skv) {
        kx = load4(kb + (long long)(kv0 + r) * kss + 4 * c);
        vx = load4(vb + (long long)(kv0 + r) * vss + 4 * c);
      }
      store4(Ks + r * ST + 4 * c, kx);
      store4(Vs + r * HD + 4 * c, vx);
    }
    __syncthreads();
    if (!active) continue;

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    const float* qr = Qs + row * ST;
#pragma unroll 4
    for (int c = 0; c < C4; ++c) {
      const float4 qv = load4(qr + 4 * c);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = load4(Ks + (sub + TPR * j) * ST + 4 * c);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mt = NEG_INF;
    bool ok[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kp = kv0 + sub + TPR * j;
      ok[j] = kp < Skv && (!causal || kp <= qpos) &&
              (window <= 0 || kp > qpos - window);
      float x = s[j];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[j] = ok[j] ? x : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float ls = 0.f;
    float* pr = Ps + row * PST;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      ls += p;
      pr[sub + TPR * j] = p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l_i = alpha * l_i + ls;
    m_i = m_new;
    __syncwarp();

#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      acc[e].x *= alpha; acc[e].y *= alpha;
      acc[e].z *= alpha; acc[e].w *= alpha;
    }
#pragma unroll 2
    for (int j4 = 0; j4 < BKV / 4; ++j4) {
      const float4 pv = load4(pr + 4 * j4);
      const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = Vs + (4 * j4 + jj) * HD;
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const float4 vv = load4(vr + 4 * (sub + TPR * e));
          acc[e].x = fmaf(pj[jj], vv.x, acc[e].x);
          acc[e].y = fmaf(pj[jj], vv.y, acc[e].y);
          acc[e].z = fmaf(pj[jj], vv.z, acc[e].z);
          acc[e].w = fmaf(pj[jj], vv.w, acc[e].w);
        }
      }
    }
  }

  if (q0 + row >= Sq) return;
  const float denom = fmaxf(l_i, 1e-30f);
  T* orow = o + (((long long)b * Sq + q0 + row) * H + h) * HD;
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    const float4 a = acc[e];
    store4(orow + 4 * (sub + TPR * e),
           make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, const long long* st, int causal,
           int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<HD, T>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / Hkv, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, softcap, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int H, int Hkv, int Sq, int Skv, const long long* st,
              int causal, int window, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                  causal, window, softcap, stream);
    case 32: return launch<32, T>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                  causal, window, softcap, stream);
    case 64: return launch<64, T>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                  causal, window, softcap, stream);
    case 128: return launch<128, T>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                    causal, window, softcap, stream);
    case 256: return launch<256, T>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                    causal, window, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fp32

// ------------------------------------------------------------ tc_prefill
namespace tc {

constexpr int BQ = 128;          // query rows per block: 2 warpgroups of 64
constexpr int NT = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int CH = 64;           // bf16 columns of one 128-byte swizzled row
constexpr int CONSUMERS = 256;   // threads that release a ring stage
constexpr float LOG2E = 1.4426950408889634f;
// more than half an SM's shared memory: one block per SM, so the
// consumers' setmaxnreg.inc always finds the producer's registers
constexpr int ONE_BLOCK_SMEM = 120 * 1024;

template <int HD>
struct Cfg {
  static constexpr int BKV = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int NC = HD / CH;                 // 128-byte chunks a row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;      // one K or V tile
  // Q, two stages of K and V, five mbarriers, slack to align to 1024
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 64 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(NT, 1) tc_prefill_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    int H, int group, int Sq, int Skv, int causal, int window, float softcap,
    float scale) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::Q_BYTES;          // stage s at + s * KV_BYTES
  const uint32_t sV = sK + 2 * C::KV_BYTES;
  const uint32_t bar_q = sV + 2 * C::KV_BYTES;  // then full[2], empty[2]
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int q0 = qb * BQ;
  const int q_offset = Skv - Sq;
  // kv tiles that hold a key some row of this block can see
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, last_pos + 1) : Skv;
  const int kv_lo =
      window > 0 ? max(0, first_pos - window + 1) / BKV * BKV : 0;
  const int n_tiles = (kv_hi - kv_lo + BKV - 1) / BKV;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int hkv = h / group;
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        tma_load(sQ + c * (BQ * 128), &tm_q, c * CH, h, q0, b, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        // the stage's previous tile (t - 2) is released by every consumer
        if (t >= 2) mbar_wait(bar_empty + 8 * s, ((t >> 1) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
        const int kv0 = kv_lo + t * BKV;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load(sK + s * C::KV_BYTES + c * (BKV * 128), &tm_k, c * CH, hkv,
                   kv0, b, bar_full + 8 * s);
          tma_load(sV + s * C::KV_BYTES + c * (BKV * 128), &tm_v, c * CH, hkv,
                   kv0, b, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int tw = tid % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int wrow0 = q0 + 64 * cw;                  // warpgroup's first row
    const int row_top = wrow0 + 16 * warp + lane / 4;  // and row_top + 8
    const bool live = wrow0 < Sq;
    const int w_first = wrow0 + q_offset;
    const int w_last = min(wrow0 + 64, Sq) - 1 + q_offset;
    const uint32_t q_base = sQ + cw * 64 * 128;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    const float scale2 = scale * LOG2E;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      const int kv0 = kv_lo + t * BKV;
      mbar_wait(bar_full + 8 * s, (t >> 1) & 1);
      const bool any = live && (!causal || kv0 <= w_last) &&
                       (window <= 0 || kv0 + BKV - 1 > w_first - window);
      if (any) {
        // S = Q K^T, 16 columns of the head dim per product
        float sc[BKV / 2];
        const uint32_t k_base = sK + s * C::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint64_t da = desc_sw128(
              q_base + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16, 1024);
          const uint64_t db = desc_sw128(
              k_base + (kk / 4) * (BKV * 128) + (kk % 4) * 32, 16, 1024);
          wgmma_ss(sc, da, db, kk > 0);
        }
        wgmma_commit_wait();
        fence_regs(sc);

        // logits in the log2 domain: scale, soft-cap, mask
        if (softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            sc[i] = softcap * tanhf(sc[i] * scale / softcap) * LOG2E;
        } else {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale2;
        }
        const bool full = kv0 + BKV <= Skv &&
                          (!causal || kv0 + BKV - 1 <= w_first) &&
                          (window <= 0 || kv0 > w_last - window);
        if (!full) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int key = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            const int pos = row_top + 8 * ((i / 2) % 2) + q_offset;
            const bool ok = key < Skv && (!causal || key <= pos) &&
                            (window <= 0 || key > pos - window);
            if (!ok) sc[i] = NEG_INF;
          }
        }

        // online softmax: the row max over the quad that shares a row
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        float alpha[2], mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          alpha[r] = exp2f(m_run[r] - m_new);
          m_run[r] = m_new;
          // a row that has seen no key yet: every p is exp2(-1e30) = 0
          mu[r] = m_new == NEG_INF ? 0.f : m_new;
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int r = (i / 2) % 2;
          sc[i] = exp2f(sc[i] - mu[r]);
          ls[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

        // O += P V: P's accumulator layout is the A operand's register
        // layout, 16 keys (8 floats) per product
        const uint32_t v_base = sV + s * C::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t db =
              desc_sw128(v_base + kk * 16 * 128, BKV * 128, 1024);
          wgmma_rs(acc, pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]),
                   pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                   pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                   pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]), db);
        }
        wgmma_commit_wait();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // epilogue: the quad's partial sums, then bf16 pairs to global memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = row_top + 8 * r;
      if (row < Sq) {
        __nv_bfloat16* orow = o + ((long long)b * Sq + row) * H * HD +
                              (long long)h * HD + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[i] * inv, acc[i + 1] * inv);
        }
      }
    }
  }
}

// a (hd, heads, rows, batch) bf16 tensor with element strides (sh, ss, sb),
// read in boxes of 64 columns x `box_heads` heads x `box_rows` rows,
// swizzled
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
             int batch, long long sh, long long ss, long long sb,
             int box_heads, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CH, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, const long long* st, int causal,
           int window, float softcap, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, HD, H, Sq, B, st[2], st[1], st[0], 1, BQ);
  if (e == 0) e = make_map(&mk, k, HD, Hkv, Skv, B, st[5], st[4], st[3], 1,
                           C::BKV);
  if (e == 0) e = make_map(&mv, v, HD, Hkv, Skv, B, st[8], st[7], st[6], 1,
                           C::BKV);
  if (e != 0) return e;
  auto kernel = tc_prefill_kernel<HD>;
  const int smem = C::SMEM > ONE_BLOCK_SMEM ? C::SMEM : ONE_BLOCK_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(mq, mk, mv, (__nv_bfloat16*)o, H,
                                     H / Hkv, Sq, Skv, causal, window,
                                     softcap, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// Split decode on the tensor cores (bf16, head dims 64 / 128 / 256): the
// Sq x group rows of one kv head (row r: query row r / group, query head
// hkv * group + r % group) fill the first rows of one consumer
// warpgroup's 64-row tile, the rest are zeros; the split's keys stream
// through the same TMA ring and the same two products as tc_prefill, in
// tiles of DBKV keys.  Writes each row's unnormalised accumulator, max
// (natural log) and sum for the merge.
constexpr int DBKV = 64;         // keys a decode tile
constexpr int DNT = 256;         // producer warpgroup + 1 consumer warpgroup

template <int HD>
struct DCfg {
  static constexpr int NC = HD / CH;
  static constexpr int Q_BYTES = 64 * HD * 2;
  static constexpr int KV_BYTES = DBKV * HD * 2;
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 64 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DNT, 1) tc_decode_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int H, int group, int Sq, int Skv,
    int causal, int window, float softcap, float scale, int kv_lo,
    int kv_hi, int chunk) {
  using C = DCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(base_ptr);
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + 2 * C::KV_BYTES;
  const uint32_t bar_q = sV + 2 * C::KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;

  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int R = Sq * group;
  const int k_begin = kv_lo + split * chunk;
  const int k_end = min(k_begin + chunk, kv_hi);
  const int n_tiles = (k_end - k_begin + DBKV - 1) / DBKV;
  const int tid = threadIdx.x;

  // rows R .. 63 of every Q chunk are zeros (the TMA box writes rows 0 ..
  // R - 1; a row's swizzled chunks stay inside its own 128 bytes)
  for (int i = tid; i < C::NC * (64 - R) * 8; i += DNT) {
    const int c = i / ((64 - R) * 8), rest = i % ((64 - R) * 8);
    reinterpret_cast<uint4*>(base_ptr + c * (64 * 128) + R * 128)[rest] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    if (tid == 0) {
      mbar_expect_tx(bar_q, C::NC * R * 128);
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        tma_load(sQ + c * (64 * 128), &tm_q, c * CH, hkv * group, 0, b,
                 bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(bar_empty + 8 * s, ((t >> 1) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
        const int kv0 = k_begin + t * DBKV;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load(sK + s * C::KV_BYTES + c * (DBKV * 128), &tm_k, c * CH,
                   hkv, kv0, b, bar_full + 8 * s);
          tma_load(sV + s * C::KV_BYTES + c * (DBKV * 128), &tm_v, c * CH,
                   hkv, kv0, b, bar_full + 8 * s);
        }
      }
    }
  } else {
    const int tw = tid - 128;
    const int warp = tw / 32, lane = tw % 32;
    const int row_top = 16 * warp + lane / 4;   // tile rows row_top, + 8
    const int q_offset = Skv - Sq;
    int pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) pos[r] = (row_top + 8 * r) / group + q_offset;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    const float scale2 = scale * LOG2E;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      const int kv0 = k_begin + t * DBKV;
      mbar_wait(bar_full + 8 * s, (t >> 1) & 1);
      float sc[DBKV / 2];
      const uint32_t k_base = sK + s * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = desc_sw128(
            sQ + (kk / 4) * (64 * 128) + (kk % 4) * 32, 16, 1024);
        const uint64_t db = desc_sw128(
            k_base + (kk / 4) * (DBKV * 128) + (kk % 4) * 32, 16, 1024);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit_wait();
      fence_regs(sc);

      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < DBKV / 2; ++i)
          sc[i] = softcap * tanhf(sc[i] * scale / softcap) * LOG2E;
      } else {
#pragma unroll
        for (int i = 0; i < DBKV / 2; ++i) sc[i] *= scale2;
      }
#pragma unroll
      for (int i = 0; i < DBKV / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int r = (i / 2) % 2;
        const bool ok = row_top + 8 * r < R && key < k_end &&
                        (!causal || key <= pos[r]) &&
                        (window <= 0 || key > pos[r] - window);
        if (!ok) sc[i] = NEG_INF;
      }

      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < DBKV / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        mu[r] = m_new == NEG_INF ? 0.f : m_new;
      }
#pragma unroll
      for (int i = 0; i < DBKV / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(sc[i] - mu[r]);
        ls[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      const uint32_t v_base = sV + s * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DBKV / 16; ++kk) {
        const uint64_t db =
            desc_sw128(v_base + kk * 16 * 128, DBKV * 128, 1024);
        wgmma_rs(acc, pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]),
                 pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                 pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                 pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]), db);
      }
      wgmma_commit_wait();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

    // partials of the valid rows: max in natural-log units, the quad's sum,
    // the unnormalised accumulator
    const int nsplit = gridDim.x;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int tr = row_top + 8 * r;
      if (tr < R) {
        const long long row = ((long long)b * Sq + tr / group) * H +
                              hkv * group + tr % group;
        float* pa = part_acc + (row * nsplit + split) * HD + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(pa + 8 * j) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        if (lane % 4 == 0) {
          part_ml[2 * (row * nsplit + split)] =
              m_run[r] == NEG_INF ? NEG_INF : m_run[r] / LOG2E;
          part_ml[2 * (row * nsplit + split) + 1] = l;
        }
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------- split_decode
namespace dec {

constexpr int NT = 256;          // threads of a split block
constexpr int RBK = 16;          // query rows a split block holds
constexpr int MAX_ROWS = 64;     // Sq x group rows of a call
constexpr int COMBINE_NT = 128;  // threads of a merge block

template <int HD, typename T>
struct Cfg {
  static constexpr int RB = HD * (int)sizeof(T);   // bytes of a K or V row
  static constexpr int KT = RB <= 256 ? 64 : (RB <= 512 ? 32 : 16);  // keys
  static constexpr int KST = RB + 16;   // padded K row: 8 rows, 8 bank groups
  static constexpr int CPR = RB / 16;   // 16-byte chunks a row
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int LG = NT / KT;    // row groups of the logits
  static constexpr int RL = (RBK + LG - 1) / LG;    // rows a logit thread
  static constexpr int CG = HD / 4;     // groups of 4 output columns
  static constexpr int RG = NT / CG;    // row slots of P V
  static constexpr int RPT = (RBK + RG - 1) / RG;   // rows a P V thread
};

template <int HD, typename T>
size_t smem_bytes(int rows) {
  using C = Cfg<HD, T>;
  return 2 * (size_t)C::KT * (C::KST + C::RB) +
         (size_t)rows * (HD + C::KT + 3) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the 16-byte chunk at `p` as floats
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// one block per (split, kv head x row block, batch row): the rows r0 .. r0 +
// nr - 1 of the kv head's Sq x group rows (row r: query head hkv * group +
// r / Sq, query row r % Sq) over the split's keys [k_begin, k_end); writes
// each row's unnormalised accumulator, max and sum
template <int HD, typename T>
__global__ void __launch_bounds__(NT) split_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int H, int group, int Sq, int Skv,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int window, float softcap, float scale, int kv_lo, int kv_hi, int chunk,
    int nrb) {
  using C = Cfg<HD, T>;
  constexpr int KT = C::KT;
  extern __shared__ float4 smem4[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(smem4);   // 2 x KT x KST
  uint8_t* Vs = Ks + 2 * KT * C::KST;                 // 2 x KT x RB
  float* Qs = reinterpret_cast<float*>(Vs + 2 * KT * C::RB);  // nr x HD
  const int split = blockIdx.x, b = blockIdx.z;
  const int hkv = blockIdx.y / nrb, r0 = blockIdx.y % nrb * RBK;
  const int nr = min(RBK, Sq * group - r0);
  float* Ps = Qs + nr * HD;                           // nr x KT
  float* m_s = Ps + nr * KT;
  float* l_s = m_s + nr;
  float* a_s = l_s + nr;

  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k_begin = kv_lo + split * chunk;
  const int k_end = min(k_begin + chunk, kv_hi);
  const int q_offset = Skv - Sq;
  const uint8_t* kb =
      reinterpret_cast<const uint8_t*>(k + b * ksb + hkv * ksh);
  const uint8_t* vb =
      reinterpret_cast<const uint8_t*>(v + b * vsb + hkv * vsh);

  auto load_tile = [&](int t, int buf) {
    const uint32_t k_dst = smem_u32(Ks + buf * KT * C::KST);
    const uint32_t v_dst = smem_u32(Vs + buf * KT * C::RB);
    for (int c = tid; c < KT * C::CPR; c += NT) {
      const int j = c / C::CPR, part = c % C::CPR;
      const int key = k_begin + t * KT + j;
      const bool ok = key < k_end;   // else zero-filled
      const long long kk = ok ? key : k_begin;
      cp_async16(k_dst + j * C::KST + 16 * part,
                 kb + kk * kss * (long long)sizeof(T) + 16 * part, ok);
      cp_async16(v_dst + j * C::RB + 16 * part,
                 vb + kk * vss * (long long)sizeof(T) + 16 * part, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int n_tiles = (k_end - k_begin + KT - 1) / KT;
  load_tile(0, 0);
  for (int idx = tid; idx < nr * HD; idx += NT) {
    const int r = r0 + idx / HD, d = idx % HD;
    Qs[idx] = to_float(q[b * qsb + (r % Sq) * qss +
                         (long long)(hkv * group + r / Sq) * qsh + d]);
  }
  if (tid < nr) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int kj = tid % KT, kg = tid / KT;    // logits: key, row group
  const int cg = tid % C::CG, slot = tid / C::CG;   // P V: columns, rows
  float4 acc[C::RPT];
#pragma unroll
  for (int e = 0; e < C::RPT; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();   // tile t - 1 is consumed: its buffer may be refilled
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int buf = t & 1;

    // logits: a thread per (key, row group); its K row is read once for
    // the group's rows kg, kg + LG, ...
    {
      const T* krow = reinterpret_cast<const T*>(Ks + buf * KT * C::KST +
                                                 kj * C::KST);
      float s[C::RL];
#pragma unroll
      for (int m = 0; m < C::RL; ++m) s[m] = 0.f;
#pragma unroll 4
      for (int c = 0; c < C::CPR; ++c) {
        float kx[C::EPC];
        load_chunk(krow + c * C::EPC, kx);
#pragma unroll
        for (int m = 0; m < C::RL; ++m) {
          const int r = kg + m * C::LG;
          if (r < nr) {
            const float* qr = Qs + r * HD + c * C::EPC;
#pragma unroll
            for (int e = 0; e < C::EPC; ++e) s[m] = fmaf(qr[e], kx[e], s[m]);
          }
        }
      }
      const int key = k_begin + t * KT + kj;
#pragma unroll
      for (int m = 0; m < C::RL; ++m) {
        const int r = kg + m * C::LG;
        if (r < nr) {
          float x = s[m] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int pos = (r0 + r) % Sq + q_offset;
          const bool ok = key < k_end && (!causal || key <= pos) &&
                          (window <= 0 || key > pos - window);
          Ps[r * KT + kj] = ok ? x : NEG_INF;
        }
      }
    }
    __syncthreads();

    // statistics: a warp per row
    for (int r = warp; r < nr; r += NT / 32) {
      float* pr = Ps + r * KT;
      float mx = NEG_INF;
      for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < KT; j += 32) {
        const float p = pr[j] == NEG_INF ? 0.f : expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P V: a thread per (4 columns, row slot), rows slot, slot + RG, ...
    const T* Vt = reinterpret_cast<const T*>(Vs + buf * KT * C::RB);
#pragma unroll
    for (int e = 0; e < C::RPT; ++e) {
      const int r = slot + e * C::RG;
      if (r < nr) {
        const float alpha = a_s[r];
        acc[e].x *= alpha; acc[e].y *= alpha;
        acc[e].z *= alpha; acc[e].w *= alpha;
      }
    }
    if (slot < nr) {
      for (int j = 0; j < KT; ++j) {
        const float4 vv = load4(Vt + j * HD + 4 * cg);
#pragma unroll
        for (int e = 0; e < C::RPT; ++e) {
          const int r = slot + e * C::RG;
          if (r < nr) {
            const float p = Ps[r * KT + j];
            acc[e].x = fmaf(p, vv.x, acc[e].x);
            acc[e].y = fmaf(p, vv.y, acc[e].y);
            acc[e].z = fmaf(p, vv.z, acc[e].z);
            acc[e].w = fmaf(p, vv.w, acc[e].w);
          }
        }
      }
    }
  }

  // partials of output row (b, i, h), split `split`
#pragma unroll
  for (int e = 0; e < C::RPT; ++e) {
    const int r = slot + e * C::RG;
    if (r < nr) {
      const int rr = r0 + r;
      const long long row =
          ((long long)b * Sq + rr % Sq) * H + hkv * group + rr / Sq;
      *reinterpret_cast<float4*>(part_acc + (row * nsplit + split) * HD +
                                 4 * cg) = acc[e];
    }
  }
  if (tid < nr) {
    const int rr = r0 + tid;
    const long long row =
        ((long long)b * Sq + rr % Sq) * H + hkv * group + rr / Sq;
    part_ml[2 * (row * nsplit + split)] = m_s[tid];
    part_ml[2 * (row * nsplit + split) + 1] = l_s[tid];
  }
}

// merges the splits of an output row in split order: a block per row; the
// weights exp(m_s - max) and the sum of the rows' sums once, then a thread
// per column
template <typename T>
__global__ void __launch_bounds__(COMBINE_NT) split_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ o, int nsplit, int hd) {
  extern __shared__ float w[];   // nsplit weights, then nsplit sums
  __shared__ float red[COMBINE_NT / 32];
  __shared__ float denom;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ml = part_ml + 2 * row * nsplit;
  float m = NEG_INF;
  for (int s = tid; s < nsplit; s += COMBINE_NT) m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < COMBINE_NT / 32; ++i) m = fmaxf(m, red[i]);
  float* ls = w + nsplit;
  for (int s = tid; s < nsplit; s += COMBINE_NT) {
    w[s] = expf(ml[2 * s] - m);
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) l = fmaf(w[s], ls[s], l);
    denom = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part_acc + row * nsplit * hd;
  for (int d = tid; d < hd; d += COMBINE_NT) {
    float a = 0.f;
#pragma unroll 16
    for (int s = 0; s < nsplit; ++s) a = fmaf(w[s], pa[s * hd + d], a);
    o[row * hd + d] = from_float<T>(a / denom);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_acc, float* part_ml, int B, int H, int Hkv, int Sq,
           int Skv, const long long* st, int causal, int window,
           float softcap, int kv_lo, int kv_hi, int chunk, int nsplit,
           cudaStream_t stream) {
  const int group = H / Hkv;
  const int rows = Sq * group;
  if (rows > MAX_ROWS || nsplit < 1 || chunk < 1 ||
      kv_lo + (long long)(nsplit - 1) * chunk >= kv_hi || kv_hi > Skv)
    return (int)cudaErrorInvalidValue;
  const int nrb = (rows + RBK - 1) / RBK;
  auto kernel = split_decode_kernel<HD, T>;
  const size_t smem = smem_bytes<HD, T>(rows < RBK ? rows : RBK);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(nsplit, Hkv * nrb, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part_acc, part_ml, H, group,
      Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, softcap, 1.0f / sqrtf((float)HD), kv_lo, kv_hi, chunk,
      nrb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  split_combine_kernel<T><<<B * Sq * H, COMBINE_NT,
                            2 * nsplit * sizeof(float), stream>>>(
      part_acc, part_ml, (T*)o, nsplit, HD);
  return (int)cudaGetLastError();
}

}  // namespace dec

// split_decode in bf16 at head dims 64 / 128 / 256: the tensor-core split
// kernel, then the same merge
template <int HD>
int tc_decode_launch(const void* q, const void* k, const void* v, void* o,
                     float* part_acc, float* part_ml, int B, int H, int Hkv,
                     int Sq, int Skv, const long long* st, int causal,
                     int window, float softcap, int kv_lo, int kv_hi,
                     int chunk, int nsplit, cudaStream_t stream) {
  using C = tc::DCfg<HD>;
  const int group = H / Hkv;
  if (Sq * group > dec::MAX_ROWS || nsplit < 1 || chunk < 1 ||
      kv_lo + (long long)(nsplit - 1) * chunk >= kv_hi || kv_hi > Skv)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int e = tc::make_map(&mq, q, HD, H, Sq, B, st[2], st[1], st[0], group, Sq);
  if (e == 0) e = tc::make_map(&mk, k, HD, Hkv, Skv, B, st[5], st[4], st[3],
                               1, tc::DBKV);
  if (e == 0) e = tc::make_map(&mv, v, HD, Hkv, Skv, B, st[8], st[7], st[6],
                               1, tc::DBKV);
  if (e != 0) return e;
  auto kernel = tc::tc_decode_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nsplit, Hkv, B), tc::DNT, C::SMEM, stream>>>(
      mq, mk, mv, part_acc, part_ml, H, group, Sq, Skv, causal, window,
      softcap, 1.0f / sqrtf((float)HD), kv_lo, kv_hi, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dec::split_combine_kernel<__nv_bfloat16>
      <<<B * Sq * H, dec::COMBINE_NT, 2 * nsplit * sizeof(float), stream>>>(
          part_acc, part_ml, (__nv_bfloat16*)o, nsplit, HD);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) with unit
// stride along hd and the given element strides over (batch, sequence,
// head), o (B, Sq, H, hd) contiguous; launches on `stream` without
// synchronizing and returns a cudaError_t (0 on success; 10000 + a
// CUresult when the driver refuses a tensor map).

// fp32_prefill: `bf16` selects bfloat16 inputs and output, else float32;
// every stride a multiple of 4 elements, every pointer 16-byte aligned.
extern "C" int fa_fp32_prefill_launch(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int H, int Hkv, int Sq, int Skv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float softcap, void* stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 0 || Sq > Skv ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  for (long long s : st)
    if (s % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? fp32::launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Hkv, Sq,
                                               Skv, st, causal, window,
                                               softcap, s)
              : fp32::launch_hd<float>(hd, q, k, v, o, B, H, Hkv, Sq, Skv,
                                       st, causal, window, softcap, s);
}

// tc_prefill: bfloat16 only, hd 64, 128 or 256; every stride a multiple of
// 8 elements (16 bytes, as TMA needs), every pointer 16-byte aligned.
extern "C" int fa_tc_prefill_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float softcap, void* stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 0 || Sq > Skv ||
      B > 65535 || (Sq + tc::BQ - 1) / tc::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  for (long long s : st)
    if (s % 8 != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return tc::launch<64>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                   causal, window, softcap, s);
    case 128: return tc::launch<128>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                     causal, window, softcap, s);
    case 256: return tc::launch<256>(q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                     causal, window, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// split_decode: `bf16` selects bfloat16, else float32; Sq x (H / Hkv) <= 64
// rows; split s of `nsplit` reads keys [kv_lo + s * chunk, min(kv_lo + (s +
// 1) * chunk, kv_hi)), none of them empty; part_acc (B * Sq * H, nsplit, hd)
// and part_ml (B * Sq * H, nsplit, 2) float32 scratch; every stride a
// multiple of 16 bytes, every pointer 16-byte aligned.
extern "C" int fa_split_decode_launch(
    const void* q, const void* k, const void* v, void* o, void* part_acc,
    void* part_ml, int bf16, int B, int H, int Hkv, int Sq, int Skv, int hd,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, float softcap, int kv_lo,
    int kv_hi, int chunk, int nsplit, void* stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 0 || Sq > Skv ||
      B > 65535 || Hkv > 65535 || kv_lo < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int align = bf16 ? 8 : 4;
  for (long long s : st)
    if (s % align != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o, (const void*)part_acc})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
#define FA_DECODE(HD, T)                                                    \
  return dec::launch<HD, T>(q, k, v, o, pa, pm, B, H, Hkv, Sq, Skv, st,     \
                            causal, window, softcap, kv_lo, kv_hi, chunk,   \
                            nsplit, s)
#define FA_TC_DECODE(HD)                                                    \
  return tc_decode_launch<HD>(q, k, v, o, pa, pm, B, H, Hkv, Sq, Skv, st,   \
                              causal, window, softcap, kv_lo, kv_hi, chunk, \
                              nsplit, s)
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 32: FA_DECODE(16, float);
    case 33: FA_DECODE(16, __nv_bfloat16);
    case 64: FA_DECODE(32, float);
    case 65: FA_DECODE(32, __nv_bfloat16);
    case 128: FA_DECODE(64, float);
    case 129: FA_TC_DECODE(64);
    case 256: FA_DECODE(128, float);
    case 257: FA_TC_DECODE(128);
    case 512: FA_DECODE(256, float);
    case 513: FA_TC_DECODE(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_DECODE
#undef FA_TC_DECODE
}
