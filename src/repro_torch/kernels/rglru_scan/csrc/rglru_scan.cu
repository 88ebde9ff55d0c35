// rglru_scan: the RG-LRU diagonal linear recurrence over (B, T, W) float32
// inputs, one thread per (batch row, channel).  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py::
// rglru_scan_kernel (body _rglru_kernel) and computes its function:
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = 0,
//
// writing every h_t and the final h.  The caller folds an initial state
// into b_0, as repro/kernels/rglru_scan/ops.py does.  Built with
// --fmad=false, so each step is one expf, one multiply and one add, each
// rounded, as in the plain PyTorch version
// repro_torch/kernels/rglru_scan/ref.py::rglru_ref.  Unlike the TPU kernel,
// which tiles T in chunks of 128 and needs T to be a multiple of the chunk,
// it takes any T: the chunks were a tiling of the TPU's VMEM, not part of
// the function.
//
// What bounds it: at the serving path's prefill shape (B 4, T 2048,
// W 4096) it reads log_a and b once (2 x 134.2 MB) and writes h (134.2 MB)
// and h_fin (64 KB): 402.7 MB, 0.120 ms at 3.35 TB/s.  Its 3 operations
// per element (101 M) take 0.0015 ms at the float32 rate, so bytes bound
// it.  What
// stands between it and that bound is memory parallelism: the recurrence
// is serial in t, and at that shape only 16,384 threads (124 per SM) exist.
//
// Design: the recurrence is diagonal, so each channel is independent.  The
// TPU grid (B, chunks) ran its chunk axis in order with the state in VMEM
// scratch; here one thread owns one (b, w) channel and steps t = 0..T-1
// itself, with h in a register.  A warp's 32 threads read 32 neighbouring
// channels of one row, so every load and store is a coalesced 128-byte
// line.  The loads run U steps ahead of the dependent multiply-add chain:
// the next U values of log_a and b are loaded into registers while the
// current U steps are computed, so each thread keeps 2U loads in flight.
// A chunked two-pass form with more threads per channel is left for later
// work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;   // threads (channels) per block
constexpr int U = 16;     // steps loaded ahead of the dependent chain

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h_out, float* __restrict__ h_fin, int T,
                  int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * T * W + w;
  const float* la = log_a + base;
  const float* bp = b + base;
  float* y = h_out + base;
  const int full = T / U * U;   // steps taken U at a time; the rest singly

  float la_next[U], b_next[U];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      la_next[i] = la[(long long)i * W];
      b_next[i] = bp[(long long)i * W];
    }
  }
  float h = 0.f;
  for (int t0 = 0; t0 < full; t0 += U) {
    float la_cur[U], b_cur[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      la_cur[i] = la_next[i];
      b_cur[i] = b_next[i];
    }
    if (t0 + U < full) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const long long off = (long long)(t0 + U + i) * W;
        la_next[i] = la[off];
        b_next[i] = bp[off];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      h = expf(la_cur[i]) * h + b_cur[i];
      y[(long long)(t0 + i) * W] = h;
    }
  }
  for (int t = full; t < T; ++t) {
    const long long off = (long long)t * W;
    h = expf(la[off]) * h + bp[off];
    y[off] = h;
  }
  h_fin[(long long)blockIdx.y * W + w] = h;
}

}  // namespace

// log_a, b, h: (B, T, W) float32, contiguous; h_fin: (B, W) float32,
// contiguous.  The initial state is zero.  Returns a CUDA error code (0:
// launched).
extern "C" int rglru_scan_launch(const void* log_a, const void* b, void* h,
                                 void* h_fin, int B, int T, int W,
                                 void* stream) {
  if (B < 0 || T < 0 || W < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)b, (float*)h, (float*)h_fin, T, W);
  return (int)cudaGetLastError();
}
