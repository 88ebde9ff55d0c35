// flash_attention: blockwise online-softmax attention over grouped kv heads,
// for the models' (B, S, H, hd) layout.  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _attn_kernel) and computes the function of
// its oracle, ref.attention_ref: causal masking end-aligned to the keys
// (query row i sits at key position i + Skv - Sq), a sliding window (keys
// more than `window` - 1 behind a row are masked), tanh logit soft-capping
// (`softcap * tanh(s / softcap)` before the mask), grouped-query attention
// (query head h reads kv head h / (H / Hkv)), softmax and accumulation in
// float32, masked logits at -1e30, the denominator clamped at 1e-30, the
// output in the inputs' type (float32 or bfloat16).  Unlike the TPU kernel
// it takes any Sq <= Skv and any head stride: the tails of the last query
// block and kv tile are masked, so decode (Sq = 1 against a cache slice of
// Skv = pos + 1 valid rows) runs through the same code.  The plain PyTorch
// version is repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
// What bounds it: at the serving path's prefill shape (B 4, H 32, Hkv 8,
// S 2048, hd 128, causal) the work is 137 GFLOP against 168 MB of inputs
// and output, so the card's bound is arithmetic (0.139 ms at the bf16
// tensor-core peak); at its decode shape (Sq 1, Skv ~2064) it is the K/V
// bytes (34 MB, ~0.01 ms).  This first version runs the products on CUDA
// cores in float32 and reaches neither bound.
//
// Design: the TPU grid (B, H, q blocks, kv blocks) runs its kv axis in
// order and keeps the running (max, denominator, accumulator) in VMEM
// scratch.  Here one block of 256 threads owns (b, h, 64 query rows) and
// loops over the kv tiles itself: four threads share a query row, each
// holding a quarter of the row's float32 accumulator in registers (float4
// chunks c = sub + 4 e) and computing the logits of every fourth key of a
// 32-key tile.  The scaled Q block and each K/V tile are staged in shared
// memory as float32 (rows padded by 4 floats so the float4 reads of four
// rows fall in different banks); the row max and sum go through two lane
// shuffles, and the tile's probabilities through a small shared array to
// the threads that own the output columns.  Tiles wholly masked by
// causality or the window are never visited (the loop bounds come from the
// block's first and last query position), and warps whose rows all lie
// past Sq skip the arithmetic.  wgmma with TMA-fed shared-memory rings, and
// keeping the query heads of one kv head in one block for decode, are left
// for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr int TPR = 4;           // threads per query row
constexpr int NT = BQ * TPR;     // threads per block
constexpr int KPT = BKV / TPR;   // keys per thread in a tile
constexpr int PST = BKV + 4;     // row stride of the probability tile
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

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) with unit stride along hd and the
// given element strides over (batch, sequence, head); o (B, Sq, H, hd)
// contiguous.  `bf16` selects bfloat16 inputs and output, else float32.
// Every stride must be a multiple of 4 and every pointer 16-byte aligned.
// Returns a cudaError_t (0 on success); launches on `stream` and does not
// synchronize.
extern "C" int flash_attention_launch(
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
  return bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Hkv, Sq, Skv,
                                         st, causal, window, softcap, s)
              : launch_hd<float>(hd, q, k, v, o, B, H, Hkv, Sq, Skv, st,
                                 causal, window, softcap, s);
}
