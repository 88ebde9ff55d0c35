// moe_gmm: the ragged grouped expert matmul out[g] = x[g] @ w[g % E], with
// rows at or past group_sizes[g] written as zero.  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py::moe_gmm_kernel
// (body _gmm_kernel) and computes its function: the product of each
// group's (C, D) rows with its expert's (D, F) weights, summed in float32
// and stored in the inputs' type (float32 or bf16), rows >= the group's
// size (clamped to [0, C]) zero.  A group index g runs over B * E groups,
// so the model's per-batch-row dispatch (x (B, E, C, D) against the shared
// w (E, D, F)) is one launch.  The plain PyTorch version is
// repro_torch/kernels/moe_gmm/ref.py::gmm_ref.
//
// What bounds it at granite-moe-3b-a800m's serving shapes (B 4, E 48
// padded experts of which 40 are routed, top-8, D 1536, F 512, capacity
// 432 rows in prefill and 8 in decode): at the path's first-layer group
// sizes a prefill gate or up product keeps ~22,000 rows (35 GFLOP, 0.035
// ms at the bf16 tensor-core peak) and moves 212 MB (the kept x rows, 38
// experts' weights, the whole output, mostly zeros: 0.063 ms at 3.35
// TB/s), the down product 337 MB (0.101 ms): bytes bound both.  A decode
// step's product is bytes alone: the weights of the experts some batch
// row routes to (11 in the first step, 19 MB, 0.0057 ms).
//
// Three bodies; kernel.py::plan names the one a call takes, from the shapes
// and the type alone (never as a fallback, never from the sizes' values):
//
// * tc_gmm (bf16, C > 16, D and F multiples of 8): a warp-specialized
//   wgmma GEMM over the ragged groups.  A block of 384 threads owns one
//   128 x 128 output tile of one group; the grid is (F / 128, C / 128,
//   E x B) with the B batch rows of one expert next to each other, so the
//   blocks that read one expert's weights run together and find them in
//   L2.  A block reads its group's size; a tile that starts past it writes
//   its zeros with 16-byte stores and returns (no x row past the size is
//   multiplied).  Otherwise one thread of the producer warpgroup feeds a
//   4-stage ring of 128-byte-swizzled shared-memory stages by TMA under
//   mbarriers (full: the bytes landed; empty: every consumer thread is done
//   with the stage): per 64-deep step of D, the x tile through a 3-D map
//   (D, C, G), whose rows past C and columns past D read as zeros, and two
//   64-column chunks of the weight tile through a 3-D map (F, D, E), read
//   as the MN-major B operand (the descriptor's transpose bit: the (D, F)
//   weights stay as they lie).  Each of two consumer warpgroups owns 64
//   rows and runs wgmma m64n128k16 with float32 accumulators, keeping one
//   step's products in flight while it waits for the next stage (with no
//   wgmma in a divergent branch, which ptxas would serialize).  The
//   epilogue rounds to bf16, writes zeros for rows past the size,
//   stages the tile in shared memory (rows padded by 16 bytes) and stores
//   it with 16-byte writes.  One block per SM (165 KB of shared memory).
// * gemv_decode (bf16, C <= 16, as at decode, D and F multiples of 8):
//   at decode a group holds at most one live row of its 8, so a tensor-core
//   tile would compute padding and, worse, each of the B groups of an expert
//   would stream that expert's weights again.  Here a block belongs to one
//   (expert, 64-column slice, slice of D): it gathers the live rows of its
//   expert's B groups (from sizes, on the device) in chunks of at most 8,
//   stages their D slice in shared memory as float32, and streams its
//   w[e] slice once with 16-byte loads, four in flight a thread (a warp
//   reads four 128-byte row segments at a time), accumulating every row of
//   the chunk in float32 registers.  The warps' sums meet in shared memory;
//   the D slices of one (expert, column slice) form a thread block cluster,
//   and after a cluster barrier each rank adds the slices' partials for its
//   share of the rows through distributed shared memory, in rank order, so
//   no float atomics are used and two launches are bitwise equal.
//   kernel.py picks the slice count (1 / 2 / 4 / 8, at least 256 rows of D
//   a slice), so the live experts' weights are streamed by a few hundred
//   blocks.  Blocks of an expert no batch row routes to write their zeros
//   and return; so does every row past its group's size.
// * fp32_tiled (float32, where tensor cores would round to TF32, past the
//   2e-5 the kernel is held to; and bf16 shapes the other two do not take):
//   one fused multiply-add per product term on the CUDA cores.  A block of
//   256 threads (16 x 16) owns one (BM x BN) output tile of one group and
//   loops over D in steps of BK rows, staging the x tile (transposed, rows
//   padded by one) and the w tile in shared memory as float32; each thread
//   keeps a TM x TN register tile for rows ty + 16 i and columns tx + 16 j.
//   A block whose first row is at or past its group's size writes its
//   zeros and returns; ragged edges in C, F and D are masked.  128 x 128
//   tiles (TM = TN = 8, BK = 16), or 16 x 64 (TM = 1, TN = 4, BK = 64) when
//   C <= 16.
#include <cooperative_groups.h>

#include "../../csrc/hopper.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// rows [r0, r1) x columns [c0, c0 + ncols) of a (C, F) bf16 group set to 0
// with 16-byte stores (ncols and F multiples of 8)
__device__ __forceinline__ void zero_rows(__nv_bfloat16* og, int r0, int r1,
                                          int c0, int ncols, int F, int tid,
                                          int nthreads) {
  const int n16 = ncols / 8;
  for (int i = tid; i < (r1 - r0) * n16; i += nthreads) {
    const int r = r0 + i / n16, c = c0 + 8 * (i % n16);
    *reinterpret_cast<uint4*>(og + (long long)r * F + c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// ------------------------------------------------------------ fp32_tiled
namespace tiled {

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

}  // namespace tiled

// ---------------------------------------------------------------- tc_gmm
namespace tc {

constexpr int BM = 128;                    // rows: 2 consumer warpgroups
constexpr int BN = 128;                    // columns of F
constexpr int BK = 64;                     // depth of D a stage
constexpr int NT = 384;                    // producer + 2 consumer groups
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;             // threads that release a stage
constexpr int A_BYTES = BM * BK * 2;       // x tile, 128 rows x 128 bytes
constexpr int W_CHUNK = BK * 128;          // 64 rows of D x 64 columns
constexpr int B_BYTES = 2 * W_CHUNK;       // the weight tile
constexpr int EPI_LD = BN + 8;             // staged output row, bf16
constexpr int EPI_BYTES = 64 * EPI_LD * 2;  // one warpgroup's rows
constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 2 * EPI_BYTES +
                     2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(NT, 1) tc_gmm_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const int* __restrict__ sizes,
    __nv_bfloat16* __restrict__ out, int E, int B, int C, int D, int F) {
  const int e = blockIdx.z / B, b = blockIdx.z % B;
  const int g = b * E + e;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int size = min(max(sizes[g], 0), C);
  const int ncols = min(BN, F - col0);
  __nv_bfloat16* og = out + (long long)g * C * F;
  const int tid = threadIdx.x;
  if (row0 >= size) {   // the whole tile lies past the group's rows
    zero_rows(og, row0, min(row0 + BM, C), col0, ncols, F, tid, NT);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sA = smem_u32(base_ptr);       // stage s at + s * A_BYTES
  const uint32_t sB = sA + STAGES * A_BYTES;    // stage s at + s * B_BYTES
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(
      base_ptr + STAGES * (A_BYTES + B_BYTES));
  const uint32_t bar_full = sB + STAGES * B_BYTES + 2 * EPI_BYTES;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int nk = (D + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full
    if (tid == 0) {
      // the second 64-column chunk is loaded only where it holds a column
      const bool hi = col0 + 64 < F;
      const int bytes = A_BYTES + (hi ? 2 : 1) * W_CHUNK;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        // the stage's previous tile (kt - STAGES) is released by every
        // consumer thread
        if (kt >= STAGES)
          mbar_wait(bar_empty + 8 * s, (kt / STAGES - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, bytes);
        tma_load(sA + s * A_BYTES, &tm_x, kt * BK, row0, g, bar_full + 8 * s);
        tma_load(sB + s * B_BYTES, &tm_w, col0, kt * BK, e, bar_full + 8 * s);
        if (hi)
          tma_load(sB + s * B_BYTES + W_CHUNK, &tm_w, col0 + 64, kt * BK, e,
                   bar_full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each.  A warpgroup whose rows all
  // lie past the size runs its products too (the epilogue writes its
  // zeros): ptxas serializes every wgmma of a kernel that issues them in a
  // divergent branch.
  const int cw = tid / 128 - 1, tw = tid % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int wrow0 = row0 + 64 * cw;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(bar_full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a_base = sA + s * A_BYTES + cw * 64 * 128;
    const uint32_t b_base = sB + s * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 columns of the K-major x tile (32 bytes in the swizzle);
      // B: 16 rows of the MN-major weight tile, chunks W_CHUNK apart
      const uint64_t da = desc_sw128(a_base + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(b_base + kk * 16 * 128, W_CHUNK, 1024);
      wgmma_ss_tb(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous step's products are done
    if (kt > 0) mbar_arrive(bar_empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: bf16 pairs (rows past the size zero) into the warpgroup's
  // staging rows, then 16-byte stores of the rows that exist
  __nv_bfloat16* st = epi + cw * 64 * EPI_LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      const int row = 16 * warp + lane / 4 + 8 * r;
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(st + row * EPI_LD + col) =
          wrow0 + row < size ? pack_bf16(acc[i], acc[i + 1]) : 0u;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  const int rows = min(64, C - wrow0), n16 = ncols / 8;   // rows < C
  for (int idx = tw; idx < rows * n16; idx += 128) {
    const int r = idx / n16, c = idx % n16;
    *reinterpret_cast<uint4*>(og + (long long)(wrow0 + r) * F + col0 +
                              8 * c) =
        *reinterpret_cast<const uint4*>(st + r * EPI_LD + 8 * c);
  }
}

// a (d0, d1, d2) bf16 tensor, contiguous, read in swizzled boxes of
// box0 (64: 128 bytes) x box1 x 1
int make_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
             int box0, int box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2,
                                 (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

int launch(const void* x, const void* w, const int* sizes, void* out, int G,
           int E, int C, int D, int F, cudaStream_t stream) {
  CUtensorMap mx, mw;
  int e = make_map(&mx, x, D, C, G, 64, BM);
  if (e == 0) e = make_map(&mw, w, F, D, E, 64, BK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      tc_gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, G);
  tc_gmm_kernel<<<grid, NT, SMEM, stream>>>(
      mx, mw, sizes, (__nv_bfloat16*)out, E, G / E, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------- gemv_decode
namespace gemv {

constexpr int NT = 256;
constexpr int COLS = 64;     // columns a block owns: 8 groups of 8
constexpr int DCH = 512;     // rows of D staged at a time
constexpr int RMAX = 8;      // live rows a chunk
constexpr int UNROLL = 4;    // weight loads in flight a thread
constexpr int MAX_SPLITS = 8;

// one chunk's rows: every row of the chunk times the block's (D slice,
// column slice) of w[e], summed over the slice; then the cluster's sum
template <int R>
__device__ __forceinline__ void chunk(
    cg::cluster_group& cluster, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
    float* xs, float* red, float* part, const int* rows, int D, int F,
    int d_lo, int d_hi, int col0, int e, int rank, int splits) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cgi = tid % 8, dg = tid / 8;   // column group, row of D (of 32)
  const int col = col0 + 8 * cgi;
  const bool col_ok = col < F;
  const __nv_bfloat16* wp = w + (long long)e * D * F + col;
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = d_lo; d0 < d_hi; d0 += DCH) {
    const int dn = min(DCH, d_hi - d0), n8 = dn / 8;
    __syncthreads();   // rows[] is set; the previous rows of xs are used
    for (int idx = tid; idx < R * n8; idx += NT) {
      const int i = idx / n8, dd = 8 * (idx % n8);
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (rows[i] >= 0)
        unpack8(*reinterpret_cast<const uint4*>(x + (long long)rows[i] * D +
                                                d0 + dd),
                v);
      float4* dst = reinterpret_cast<float4*>(xs + i * DCH + dd);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    for (int dd = dg; dd < dn; dd += UNROLL * 32) {
      uint4 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int d = dd + 32 * u;
        wv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (col_ok && d < dn)
          wv[u] = __ldg(reinterpret_cast<const uint4*>(
              wp + (long long)(d0 + d) * F));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int d = dd + 32 * u;
        if (d < dn) {
          float wf[8];
          unpack8(wv[u], wf);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float xv = xs[i * DCH + d];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
          }
        }
      }
    }
  }

  // the block's sum: lanes l, l ^ 8, l ^ 16, l ^ 24 share a column group,
  // then the 8 warps in order
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * R + i) * COLS + 8 * lane + j] = acc[i][j];
  }
  __syncthreads();
  for (int idx = tid; idx < R * COLS; idx += NT) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) s += red[wi * R * COLS + idx];
    part[idx] = s;
  }
  cluster.sync();   // every rank's partial is written

  // rank k stores the chunk rows i with i % splits == k: the D slices'
  // partials added in rank order
  if (tid < R * 8) {
    const int i = tid / 8, cq = tid % 8, c = col0 + 8 * cq;
    if (i % splits == rank && rows[i] >= 0 && c < F) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < splits; ++q) {
        const float* rp = cluster.map_shared_rank(part, q) + i * COLS + 8 * cq;
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] += rp[j];
      }
      uint4 o;
      o.x = pack_bf16(s[0], s[1]);
      o.y = pack_bf16(s[2], s[3]);
      o.z = pack_bf16(s[4], s[5]);
      o.w = pack_bf16(s[6], s[7]);
      *reinterpret_cast<uint4*>(out + (long long)rows[i] * F + c) = o;
    }
  }
  cluster.sync();   // no rank reads this partial any more
}

// grid (splits, F / COLS, E), clusters of `splits` blocks along x: block
// (rank, slice, e) covers rows [rank * dsz, (rank + 1) * dsz) of D
__global__ void __launch_bounds__(NT) gemv_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, int E,
    int B, int C, int D, int F, int dsz) {
  __shared__ __align__(16) float xs[RMAX * DCH];
  __shared__ float red[(NT / 32) * RMAX * COLS];
  __shared__ float part[RMAX * COLS];
  __shared__ int rows[RMAX];   // g * C + r of each chunk row, -1: none
  __shared__ int n_live;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, splits = gridDim.x;
  const int col0 = blockIdx.y * COLS, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int d_lo = rank * dsz, d_hi = min(D, d_lo + dsz);

  if (tid == 0) {
    int n = 0;
    for (int b = 0; b < B; ++b) n += min(max(sizes[b * E + e], 0), C);
    n_live = n;
  }
  // rows past each group's size: zeros (this rank's share of the rows)
  for (int idx = tid; idx < B * C * 8; idx += NT) {
    const int row = idx / 8, c = col0 + 8 * (idx % 8);
    if (row % splits != rank || c >= F) continue;
    const int b = row / C, r = row % C, g = b * E + e;
    if (r >= min(max(sizes[g], 0), C))
      *reinterpret_cast<uint4*>(out + ((long long)g * C + r) * F + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int n = n_live;   // the same in every rank of the cluster
  const int R = n <= 4 ? 4 : RMAX;
  for (int c0 = 0; c0 < n; c0 += R) {
    if (tid < R) {
      // live row c0 + tid: the expert's groups in batch order, their rows
      // in order
      int i = c0 + tid, found = -1;
      for (int b = 0; b < B && found < 0; ++b) {
        const int s = min(max(sizes[b * E + e], 0), C);
        if (i < s) found = (b * E + e) * C + i;
        else i -= s;
      }
      rows[tid] = found;
    }
    if (R == 4)
      chunk<4>(cluster, x, w, out, xs, red, part, rows, D, F, d_lo, d_hi,
               col0, e, rank, splits);
    else
      chunk<RMAX>(cluster, x, w, out, xs, red, part, rows, D, F, d_lo, d_hi,
                  col0, e, rank, splits);
  }
}

int launch(const void* x, const void* w, const int* sizes, void* out, int G,
           int E, int C, int D, int F, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int dsz = ((D + splits - 1) / splits + 7) / 8 * 8;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (F + COLS - 1) / COLS, E);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_decode_kernel, (const __nv_bfloat16*)x,
      (const __nv_bfloat16*)w, sizes, (__nv_bfloat16*)out, E, G / E, C, D,
      F, dsz);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gemv

bool bad_shape(int G, int E, int C, int D, int F) {
  return G < 0 || E < 1 || C < 0 || D < 0 || F < 0 || G % E != 0 ||
         G > 65535;
}

}  // namespace

// Every entry point takes x (G, C, D) contiguous, G = B * E groups; w (E,
// D, F) contiguous, group g using expert g % E; sizes (G,) int32; out (G,
// C, F) contiguous; launches on `stream` without synchronizing and returns
// a cudaError_t (0 on success; 10000 + a CUresult when the driver refuses a
// tensor map).

// fp32_tiled: all float32 (bf16 = 0) or all bf16 (bf16 = 1).
extern "C" int moe_gmm_fp32_tiled_launch(const void* x, const void* w,
                                         const void* sizes, void* out,
                                         int bf16, int G, int E, int C,
                                         int D, int F, void* stream) {
  if (bad_shape(G, E, C, D, F)) return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || F == 0) return 0;
  const int* s = (const int*)sizes;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? tiled::dispatch<__nv_bfloat16>(x, w, s, out, G, E, C, D, F,
                                               st)
              : tiled::dispatch<float>(x, w, s, out, G, E, C, D, F, st);
}

// tc_gmm: bf16, C > 16, D and F positive multiples of 8, x and w 16-byte
// aligned.
extern "C" int moe_gmm_tc_launch(const void* x, const void* w,
                                 const void* sizes, void* out, int G, int E,
                                 int C, int D, int F, void* stream) {
  if (bad_shape(G, E, C, D, F) || D == 0 || D % 8 != 0 || F % 8 != 0 ||
      C > 65535 * tc::BM)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || F == 0) return 0;
  return tc::launch(x, w, (const int*)sizes, out, G, E, C, D, F,
                    (cudaStream_t)stream);
}

// gemv_decode: bf16, D and F multiples of 8, x, w and out 16-byte aligned;
// the D axis cut into `splits` (1 .. 8) slices, one cluster rank each.
extern "C" int moe_gmm_gemv_launch(const void* x, const void* w,
                                   const void* sizes, void* out, int G,
                                   int E, int C, int D, int F, int splits,
                                   void* stream) {
  if (bad_shape(G, E, C, D, F) || D % 8 != 0 || F % 8 != 0 ||
      (F + gemv::COLS - 1) / gemv::COLS > 65535)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || F == 0) return 0;
  return gemv::launch(x, w, (const int*)sizes, out, G, E, C, D, F, splits,
                      (cudaStream_t)stream);
}
