// moe_gmm: the ragged grouped expert matmul out[g] = x[g] @ w[g % E], with
// rows at or past group_sizes[g] written as zero.  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py::moe_gmm_kernel
// (body _gmm_kernel) and computes its function: the product of each
// group's (C, D) rows with its expert's (D, F) weights, summed in float32
// and stored in the inputs' type (float32 or bf16), rows >= the group's
// size zero and their row tiles skipped.  A group index g runs over
// B * E groups, so the model's per-batch-row dispatch (x (B, E, C, D)
// against the shared w (E, D, F)) is one launch.  The plain PyTorch
// version is repro_torch/kernels/moe_gmm/ref.py::gmm_ref.
//
// What bounds it at granite-moe-3b-a800m's serving shapes (B 4, E 48
// padded experts of which 40 are routed, top-8, D 1536, F 512, capacity
// 432 rows in prefill and 8 in decode): one prefill gate or up product
// does at most 2 * 65,536 kept rows * 1536 * 512 = 103 GFLOP, 0.104 ms at
// the bf16 tensor-core peak, and moves ~350 MB (the kept x rows, the 40
// experts' weights, the whole output), also ~0.104 ms at 3.35 TB/s; the
// down product moves ~385 MB, so bytes bound it (~0.115 ms).  A decode
// step's product is bytes alone: at most 32 experts' weights (~50 MB,
// ~0.015 ms).
//
// This first version does its arithmetic on the CUDA cores, one fused
// multiply-add per product term in float32 (a tensor-core path would
// round float32 inputs to TF32, beyond the 2e-5 the kernel is held to).
// So at prefill it is bound by the float32 FMA rate (67 TFLOP/s peak),
// not by the bound above; wgmma tiles for the bf16 path are later work.
//
// Design: the TPU grid (E, C tiles, F tiles, D tiles) runs its D axis in
// order and keeps the (bc, bf) accumulator in VMEM scratch; here a block
// of 256 threads (16 x 16) owns one (BM x BN) output tile of one group and
// loops over the D axis itself in steps of BK rows.  Each step stages the
// x tile (transposed, rows padded by one to spread the banks) and the w
// tile in shared memory as float32; each thread keeps a TM x TN register
// tile of float32 accumulators for rows ty + 16 i and columns tx + 16 j,
// so the threads of a half-warp read 16 neighbouring w columns and one
// broadcast x value.  Each block loads its group's size itself (the TPU's
// scalar prefetch); a block whose first row is at or past it writes its
// zeros and returns, and x rows past it are never read.  Ragged edges in
// C, F and D are masked.  Two tile shapes: 128 x 128 (TM = TN = 8, BK =
// 16) for prefill's capacities, 16 x 64 (TM = 1, TN = 4) when C <= 16, as
// in decode, where a 128-row tile would compute 120 rows of padding; its
// BK = 64 puts four times the weight loads in flight per step and takes
// a quarter of the steps, each of them a load, a barrier and a compute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block, 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int TM, int TN, int BK>
__global__ void __launch_bounds__(NT)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ sizes, T* __restrict__ out, int E,
               int C, int D, int F) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int size = min(max(sizes[g], 0), C);
  T* op = out + (long long)g * C * F;

  if (row0 >= size) {   // the whole tile lies past the group's rows
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = row0 + i / BN, c = col0 + i % BN;
      if (r < C && c < F) op[(long long)r * F + c] = from_f32<T>(0.0f);
    }
    return;
  }

  const T* xp = x + (long long)g * C * D;
  const T* wp = w + (long long)(g % E) * D * F;
  const int rows = min(BM, size - row0);   // valid rows of this tile
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      float v = 0.0f;
      if (m < rows && k0 + kk < D)
        v = to_f32(xp[(long long)(row0 + m) * D + k0 + kk]);
      xs[kk][m] = v;
    }
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN;
      float v = 0.0f;
      if (k0 + kk < D && col0 + n < F)
        v = to_f32(wp[(long long)(k0 + kk) * F + col0 + n]);
      ws[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < F)
        op[(long long)r * F + c] = from_f32<T>(r < size ? acc[i][j] : 0.0f);
    }
  }
}

template <typename T, int TM, int TN, int BK>
int launch(const void* x, const void* w, const int* sizes, void* out, int G,
           int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, G);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  moe_gmm_kernel<T, TM, TN, BK><<<grid, NT, 0, stream>>>(
      (const T*)x, (const T*)w, sizes, (T*)out, E, C, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const int* sizes, void* out,
             int G, int E, int C, int D, int F, cudaStream_t stream) {
  if (C <= 16)
    return launch<T, 1, 4, 64>(x, w, sizes, out, G, E, C, D, F, stream);
  return launch<T, 8, 8, 16>(x, w, sizes, out, G, E, C, D, F, stream);
}

}  // namespace

// x: (G, C, D) contiguous, G = B * E groups; w: (E, D, F) contiguous, group
// g using expert g % E; sizes: (G,) int32; out: (G, C, F) contiguous.  All
// float32 (bf16 = 0) or all bf16 (bf16 = 1).  Returns a CUDA error code
// (0: launched).
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* sizes,
                              void* out, int bf16, int G, int E, int C,
                              int D, int F, void* stream) {
  if (G < 0 || E < 1 || C < 0 || D < 0 || F < 0 || G % E != 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || F == 0) return 0;
  const int* s = (const int*)sizes;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(x, w, s, out, G, E, C, D, F, st)
              : dispatch<float>(x, w, s, out, G, E, C, D, F, st);
}
