// rwkv6_scan: the chunk-parallel RWKV-6 WKV recurrence, per (batch, head),
// for the models' layout read through strides.  CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel (body _rwkv_kernel) and computes its function, chunk by
// chunk of CHUNK = 16 steps (the TPU kernel in float32, this one in double,
// see Precision below):
//
//   cum      = inclusive cumsum of logw over the chunk's rows
//   q_t      = r * exp(cum - logw)          (the exclusive cumsum)
//   k_in     = k * exp(-cum)
//   k_end    = k * exp(cum_end - cum)       (cum_end: the chunk's last row)
//   A[t][s]  = q_t[t] . k_in[s] for s < t, else 0      (strictly causal)
//   bonus[t] = r[t] . (u * k[t])
//   y[t]     = (A v)[t] + bonus[t] v[t] + q_t[t] S
//   S        = diag(exp(cum_end)) S + k_end^T v
//
// with the state S (K x V) carried from chunk to chunk and written out at
// the end.  Unlike the TPU kernel, which always starts from zero, it takes
// an initial state (a null pointer means zeros), so every chunked call of
// the model's time mix, whatever its state, runs here.  The caller clamps
// logw at -4 (LOGW_MIN), which bounds every exponential by e^64.  The
// plain PyTorch version is repro_torch/kernels/rwkv6_scan/ref.py::wkv_ref,
// the step-by-step scan.
//
// Precision: everything after the float32 loads is double, and y and the
// state are rounded to float32 once, at the store.  In float32 the chunked
// form is less exact than the step-by-step scan: the cumsum's rounding (an
// absolute error of a few 1e-6 at |cum| up to 64) becomes a relative error
// of the factors e^{+-cum}, and at the serving path's shape the TPU
// kernel's float32 arithmetic puts y up to 6e-5 from the exact recurrence
// (measured against a float64 scan), beyond the rtol = atol = 2e-5 the
// kernel is held to against the plain version.  In double the kernel's own
// error is the final rounding, and what is left of the gap is the plain
// version's.  The state update uses k_end = k_in e^{cum_end}, exact in
// double, so S = diag(e^{cum_end}) (S + k_in^T v).
//
// What bounds it: at the serving path's prefill shape (B*H 160, T 2048,
// K 64) it reads r, k, v and logw once (336 MB) and writes y (84 MB) and
// the state (2.6 MB): 0.126 ms at 3.35 TB/s; its ~7 GFLOP take 0.10 ms at
// the float32 peak, so bytes bound it on paper.  This first version is
// bound by its serial chain instead: T/16 dependent chunks per block, and
// by the card's double rate (half the float32 rate on the H100).
//
// Design: the TPU grid (B*H, chunks) runs its chunk axis in order and keeps
// S in VMEM scratch.  Here one block of 256 threads owns (b, h, a tile of
// 16 state columns) and loops over the chunks itself; a tile's columns of
// S, y and v are independent of the other tiles', and only the 16 x 16 A
// is recomputed per tile, so B*H*K/16 blocks (640 at the path's shape)
// fill the card's 132 SMs.  Per chunk: the r, k and logw rows and the v
// tile are staged in shared memory (rows padded to K + 1 elements, so the
// threads of a warp reading 16 rows of one column hit distinct banks); K
// threads take the cumsum down their column; all threads take the
// exponentials; one thread per (t, s) entry of A (the diagonal ones
// compute the bonus), one per (t, column) of y, and 16 x K / 256 per entry
// of the S tile, which stays in shared memory.  Each dot product sums in
// index order.  Double-buffered loads and tensor-core products (wgmma) are
// left for later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 16;    // steps per chunk, as the TPU kernel's
constexpr int VT = 16;       // state columns per block
constexpr int NT = 256;      // threads per block: CHUNK x CHUNK, CHUNK x VT

struct Strides {
  long long b, h, t;         // element strides; the K axis has stride 1
};

template <int K>
__global__ void __launch_bounds__(NT)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_fin, int H,
                  int T, Strides sr_, Strides sk_, Strides sv_, Strides sl_,
                  Strides sy_) {
  constexpr int KP = K + 1;  // padded row stride
  __shared__ float sr[CHUNK][KP], sk[CHUNK][KP];    // this chunk's r, k
  __shared__ double sc[CHUNK][KP];                  // logw, then its cumsum
  __shared__ double sq[CHUNK][KP], ski[CHUNK][KP];  // q_t, k_in
  __shared__ double sv[CHUNK][VT];                  // this tile's v
  __shared__ double sa[CHUNK][CHUNK + 1];           // A
  __shared__ double sb[CHUNK];                      // bonus
  __shared__ float su[K];
  __shared__ double ss[K][VT];                      // the state tile

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * VT;
  const float* rp = r + b * sr_.b + h * sr_.h;
  const float* kp = k + b * sk_.b + h * sk_.h;
  const float* vp = v + b * sv_.b + h * sv_.h + v0;
  const float* lp = lw + b * sl_.b + h * sl_.h;
  float* yp = y + b * sy_.b + h * sy_.h + v0;
  float* sp = s_fin + (long long)bh * K * K + v0;

  for (int e = tid; e < K; e += NT) su[e] = u[h * K + e];
  for (int e = tid; e < K * VT; e += NT) {
    const int kk = e / VT, j = e % VT;
    ss[kk][j] = s0 ? s0[(long long)bh * K * K + kk * K + v0 + j] : 0.0;
  }

  // (t, s) of A and (t, column) of y: one entry per thread
  const int row = tid / CHUNK, col = tid % CHUNK;
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    for (int e = tid; e < CHUNK * K; e += NT) {
      const int i = e / K, kk = e % K;
      const long long t = t0 + i;
      sr[i][kk] = rp[t * sr_.t + kk];
      sk[i][kk] = kp[t * sk_.t + kk];
      sc[i][kk] = lp[t * sl_.t + kk];
    }
    sv[row][col] = vp[(long long)(t0 + row) * sv_.t + col];
    __syncthreads();

    if (tid < K)
      for (int i = 1; i < CHUNK; ++i) sc[i][tid] += sc[i - 1][tid];
    __syncthreads();

    // q_t = r e^{cum - logw} (the exclusive cumsum), k_in = k e^{-cum}
    for (int e = tid; e < CHUNK * K; e += NT) {
      const int i = e / K, kk = e % K;
      sq[i][kk] = sr[i][kk] * exp(i ? sc[i - 1][kk] : 0.0);
      ski[i][kk] = sk[i][kk] * exp(-sc[i][kk]);
    }
    __syncthreads();

    {
      double a = 0.0;
      if (col < row) {
        for (int kk = 0; kk < K; ++kk) a += sq[row][kk] * ski[col][kk];
      } else if (col == row) {
        double bonus = 0.0;
        for (int kk = 0; kk < K; ++kk)
          bonus += (double)sr[row][kk] * (su[kk] * sk[row][kk]);
        sb[row] = bonus;
      }
      sa[row][col] = a;
    }
    __syncthreads();

    {
      double intra = 0.0;
      for (int s = 0; s < row; ++s) intra += sa[row][s] * sv[s][col];
      intra += sb[row] * sv[row][col];
      double inter = 0.0;
      for (int kk = 0; kk < K; ++kk) inter += sq[row][kk] * ss[kk][col];
      yp[(long long)(t0 + row) * sy_.t + col] = (float)(intra + inter);
    }
    __syncthreads();

    // S = diag(e^{cum_end}) (S + k_in^T v): k_end = k_in e^{cum_end}
    for (int e = tid; e < K * VT; e += NT) {
      const int kk = e / VT, j = e % VT;
      double delta = 0.0;
      for (int s = 0; s < CHUNK; ++s) delta += ski[s][kk] * sv[s][j];
      ss[kk][j] = exp(sc[CHUNK - 1][kk]) * (ss[kk][j] + delta);
    }
    __syncthreads();
  }

  for (int e = tid; e < K * VT; e += NT) {
    const int kk = e / VT, j = e % VT;
    sp[kk * K + j] = (float)ss[kk][j];
  }
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* s_fin, int B,
           int H, int T, const Strides* st, cudaStream_t stream) {
  const dim3 grid(B * H, K / VT);
  rwkv6_scan_kernel<K><<<grid, NT, 0, stream>>>(
      r, k, v, lw, u, s0, y, s_fin, H, T, st[0], st[1], st[2], st[3], st[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, logw: (B, H, T, K) float32 read through the strides (element
// strides of b, h, t for each, in that order; unit stride along K); u:
// (H, K) contiguous; s0: (B, H, K, K) contiguous or null (zeros); y:
// (B, H, T, K) written through its strides; s_fin: (B, H, K, K)
// contiguous.  T a multiple of 16, K one of 16, 32, 64.  Returns a CUDA
// error code (0: launched).
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* s0, void* y, void* s_fin, int B, int H,
    int T, int K, const long long* strides, void* stream) {
  if (B < 0 || H < 1 || T < 0 || T % CHUNK != 0 ||
      B * (long long)H > 2147483647)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *lf = (const float*)logw,
              *uf = (const float*)u, *sf = (const float*)s0;
  float *yf = (float*)y, *of = (float*)s_fin;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 16: return launch<16>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, s);
    case 32: return launch<32>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, s);
    case 64: return launch<64>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
