// rwkv6_scan: the chunk-parallel RWKV-6 WKV recurrence, one block per
// (batch, head), for the models' layout read through strides.  CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel (body _rwkv_kernel) and computes its function, chunk by
// chunk of CHUNK = 16 steps (the TPU kernel in float32, this one in double,
// see Precision below):
//
//   cum      = inclusive cumsum of logw over the chunk's rows
//   q_t      = r * exp(cum - logw)          (the exclusive cumsum)
//   k_in     = k * exp(-cum)
//   A[t][s]  = q_t[t] . k_in[s] for s < t, bonus[t] for s = t, else 0
//   bonus[t] = r[t] . (u * k[t])
//   y[t]     = (A v)[t] + q_t[t] S
//   S        = diag(exp(cum_end)) (S + k_in^T v)     (cum_end: last row)
//
// with the state S (K x V, V = K) carried from chunk to chunk and written
// out at the end.  Unlike the TPU kernel, which always starts from zero, it
// takes an initial state (a null pointer means zeros), so every chunked
// call of the model's time mix, whatever its state, runs here.  The caller
// clamps logw at -4 (LOGW_MIN), which bounds every exponential by e^64.  The
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
// version's.  Sums run in another order than the plain version's; where
// every term is an integer (logw = 0, small integer r, k, v, u, s0: the
// coverage probe) each sum is exact and the kernel equals the plain
// version bitwise.
//
// What bounds it: at the serving path's prefill shape (B*H 160, T 2048,
// K 64) it reads r, k, v and logw once (336 MB) and writes y (84 MB) and
// the state (2.6 MB): 0.127 ms at 3.35 TB/s.  In double its ~150 K
// multiply-adds a chunk and head (q S and the state update 64 K each, A
// and A v 8 K each) and 16 x 64 exponentials come to ~6.4 GFLOP: 0.095 ms
// at the FP64 tensor cores' 67 TFLOP/s, 0.19 ms at the vector FP64 rate
// (34).  What holds it is each block's serial loop of 128 chunks, one
// warp a scheduler: a chunk's factors, A and chain run one after the
// other between barriers, each at the latency of its dependent steps; and
// 160 heads on 132 SMs put two blocks on 28 SMs, which set the time.
//
// Design: one block of K / 16 warps (128 threads at K 64) owns a head and
// loops over its T / 16 chunks; the TPU grid's sequential chunk axis and
// VMEM state become that loop and registers.
//  * Rows staged ahead: chunk c + 2's r, k, logw and v rows go to a
//    three-chunk ring in shared memory with cp.async (16-byte copies where
//    the tensors allow) while chunk c runs, so no chunk waits on global
//    memory; two barriers a chunk (the PR 16 body: six).
//  * Factors once per (b, h, chunk): the two lanes of a column take the
//    cumsum of eight rows each (the second from the first's sum through a
//    shuffle), e^{cum} of each row once (exp_scan: a 64-entry table and a
//    degree-5 polynomial, about half the FP64 instructions of CUDA's exp),
//    q from the row before's and k_in from its reciprocal, e^{cum_end} once
//    a column (the PR 16 body took 2 x 16 exponentials per element of each
//    16-column tile, e^{cum_end} 16 times an element); the bonus is summed
//    over a warp's columns with shuffles.
//  * Every product on the FP64 tensor cores, sm_90's mma.sync m16n8k8 and
//    m16n8k16 (~125 multiply-adds a clock and SM on the card, m8n8k4 ~62,
//    the vector DFMA ~52; benchmarks/torch_fp64_rates.py): A's two column
//    tiles on warps 0 and 1, y and the update on all.
//  * The state in registers: warp w holds rows v = 16w..16w+15 of S^T as
//    K / 8 accumulator tiles of 16 x 8, and both products that read it use
//    it in place: y^T = S^T q^T takes a tile as its A operand (its inner
//    index j <-> k = 8i + 2j, j + 4 <-> 8i + 2j + 1: any order of an inner
//    index gives the same sum, and q's B operand becomes two adjacent
//    doubles), the update S^T += v^T k_in takes the tiles as accumulators.
//    Rows of q and k_in padded to K + 4 doubles, A's to 20 and the staged
//    rows to K + 8 floats: every operand load takes the fewest wavefronts
//    its bytes need (tests/test_torch_rwkv6_schedule.py).
//  * The work that does not read S (factors, A, the bonus, the intra-chunk
//    A v) is done across the warps before each chunk's chain; only y's
//    q S and the update read and write the state, warp by warp.  Running
//    chunk c + 1's factors and A beside chunk c's chain in the same warps
//    was measured slower (0.54 against 0.52 ms: at 218 registers a thread
//    the compiler did not interleave them), and so were eight warps with
//    the state split by halves of k (0.59 ms, spilling at 128 registers).
//  * A chunk-parallel form that wrote each chunk's k_in^T v to device
//    memory would add ~335 MB at the path's shape, more than the bytes
//    bound itself; the serial chain here moves only the rows.
// phases: factors (warp 0); barrier (b); A (warp 0); barrier (c); y (warp 0); state update (warp 0)
#include <cuda_runtime.h>
#include <math.h>

#ifdef RWKV6_SCAN_PHASES
// clock64() stamps of a chunk's phases, for benchmarks/
// torch_rwkv6_scan_phases.py only: thread 0 adds the cycles since the
// previous stamp to phase k's counter; the counters are summed over
// blocks.
namespace {
constexpr int N_PH = 8;
__device__ unsigned long long g_phase_cycles[N_PH];
}
#define PH_INIT() long long ph_acc_[N_PH] = {}; long long ph_last_ = clock64()
#define PH(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  ph_acc_[k] += t_ - ph_last_; ph_last_ = t_; } } while (0)
#define PH_FLUSH() do { if (threadIdx.x == 0) for (int k_ = 0; k_ < N_PH; \
  ++k_) atomicAdd(&g_phase_cycles[k_], (unsigned long long)ph_acc_[k_]); \
  } while (0)
extern "C" int rwkv6_scan_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                       N_PH * sizeof(unsigned long long));
  if (reset) {
    unsigned long long z[N_PH] = {};
    cudaMemcpyToSymbol(g_phase_cycles, z, sizeof z);
  }
  return (int)e;
}
#else
#define PH_INIT() do {} while (0)
#define PH(k) do {} while (0)
#define PH_FLUSH() do {} while (0)
#endif

namespace {

constexpr int CHUNK = 16;    // steps per chunk, as the TPU kernel's
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, t;         // element strides; the K axis has stride 1
};

// D = A B + D on the FP64 tensor cores for a 16 x 8 tile (sm_90's
// mma.sync m16n8k8 and m16n8k16; benchmarks/torch_fp64_rates.py checks
// these layouts on the card).  Lane (g, j) = (lane / 4, lane % 4) gives
// a[m] = A[g + 8 (m & 1)][j + 4 (m >> 1)] and b[m] = B[j + 4 m][g], and
// holds d[m] = D[g + 8 (m >> 1)][2 j + (m & 1)].
__device__ __forceinline__ void mma_k8(double (&d)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma_k16(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// e^x in double for |x| <= 700 from a 64-entry table T[j] = 2^(j/64) in
// shared memory: x = (64 m + j) ln2/64 + r with |r| <= ln2/128, e^r by
// its degree-5 Taylor polynomial (remainder below 4e-17), the power of two
// added to the exponent.  A few ulp from e^x; exactly 1 at x = 0; NaN in,
// NaN out.  About half the FP64 instructions of CUDA's exp.
__device__ __forceinline__ double exp_scan(double x, const double* T) {
  constexpr double INV = 0x1.71547652b82fep+6;       // 64 / ln 2
  constexpr double HI = 0x1.62e42fee00000p-7;        // ln 2 / 64, high
  constexpr double LO = 0x1.a39ef35793c76p-39;       // and the rest
  const double n = rint(x * INV);
  double r = fma(-n, HI, x);
  r = fma(-n, LO, r);
  const int ni = (int)n;
  double p = fma(r, 1.0 / 120.0, 1.0 / 24.0);
  p = fma(p, r, 1.0 / 6.0);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  return __longlong_as_double(__double_as_longlong(T[ni & 63] * p) +
                              (long long)(ni >> 6) * (1LL << 52));
}

// Shared-memory layout (kernel and launch agree through these).
template <int K>
struct Smem {
  static constexpr int NW = K / 16;     // warps; warp w owns S^T rows 16w..
  static constexpr int NT = 32 * NW;
  static constexpr int FS = K + 8;      // float row stride of staged rows
  static constexpr int QS = K + 4;      // double row stride of q, k_in
  static constexpr int AS = CHUNK + 4;  // double row stride of A
  static constexpr int STAGE = 4 * CHUNK * FS;   // r, k, logw, v rows
  static constexpr int NSTAGE = 3;      // chunks in the ring
  // per chunk parity: q, k_in, e^{cum_end}
  static constexpr int FACT = 2 * CHUNK * QS + K;
  static constexpr size_t bytes =
      sizeof(double) * (2 * FACT + CHUNK * AS + NW * CHUNK + 64) +
      sizeof(float) * (K + NSTAGE * STAGE);
};

template <int K>
__global__ void __launch_bounds__(Smem<K>::NT, 2)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_fin, int H,
                  int T, Strides sr_, Strides sk_, Strides sv_, Strides sl_,
                  Strides sy_, int aligned) {
  using L = Smem<K>;
  constexpr int NT = L::NT, NW = L::NW;
  constexpr int FS = L::FS, QS = L::QS, AS = L::AS;
  constexpr int NI = K / 8;             // 8-column tiles of S^T a warp holds
  extern __shared__ double smem[];
  double* fact = smem;                  // 2 x (q, k_in, e^{cum_end})
  double* ah = fact + 2 * L::FACT;      // CHUNK x AS: A with the bonus
  double* bpart = ah + CHUNK * AS;      // NW x CHUNK: the bonus by warp
  double* etab = bpart + NW * CHUNK;    // 64: 2^(j/64)
  float* uf = reinterpret_cast<float*>(etab + 64);   // K
  float* stage = uf + K;                // 3 x (r, k, logw, v) x CHUNK x FS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, j = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float* src[4] = {r + b * sr_.b + h * sr_.h, k + b * sk_.b + h * sk_.h,
                         lw + b * sl_.b + h * sl_.h,
                         v + b * sv_.b + h * sv_.h};
  const long long sts[4] = {sr_.t, sk_.t, sl_.t, sv_.t};
  float* yp = y + b * sy_.b + h * sy_.h;

  // stage chunk c's rows into ring slot c % 3: 16-byte piece e (row
  // e / (K/4), columns 4 (e % (K/4)) ..+3) of each array, e = tid, tid + NT
  const int n_chunks = T / CHUNK;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* d = stage + (c % L::NSTAGE) * L::STAGE;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = tid; e < CHUNK * K / 4; e += NT) {
          const int i = e / (K / 4), q4 = (e % (K / 4)) * 4;
          const float* s = src[a] + ((long long)c * CHUNK + i) * sts[a] + q4;
          float* dd = d + (a * CHUNK + i) * FS + q4;
          if (aligned) {
            cp_async16(dd, s);
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x) cp_async4(dd + x, s + x);
          }
        }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };
  issue(0);
  issue(1);

  for (int e = tid; e < K; e += NT) uf[e] = u[h * K + e];
  for (int e = tid; e < 64; e += NT) etab[e] = exp2((double)e / 64.0);
  // S^T[16 warp + g + 8 (m >> 1)][8 i + 2 j + (m & 1)] in st[i][m]
  double st[NI][4];
  const int v0 = 16 * warp;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      st[i][m] = s0 ? (double)s0[(long long)bh * K * K +
                                 (8 * i + 2 * j + (m & 1)) * K + v0 + g +
                                 8 * (m >> 1)]
                    : 0.0;
  cp_async_wait<1>();
  __syncthreads();     // chunk 0 staged; uf and the table written
  PH_INIT();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const float* sr = stage + (ch % L::NSTAGE) * L::STAGE;
    const float* sk = sr + CHUNK * FS;
    const float* sl = sk + CHUNK * FS;
    const float* sv = sl + CHUNK * FS;
    double* qs = fact + (ch & 1) * L::FACT;
    double* kis = qs + CHUNK * QS;
    double* eend = kis + CHUNK * QS;    // e^{cum_end}

    // ---- factors: lane (column kc, half rh) takes rows 8 rh..8 rh + 7
    {
      const int kc = tid >> 1, rh = tid & 1;
      double run = 0.0, loc[8], bon[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * rh + i;
        run += (double)sl[t * FS + kc];
        loc[i] = run;
        bon[i] = (double)sr[t * FS + kc] * (double)(uf[kc] * sk[t * FS + kc]);
      }
      // the cumsum before row 8 rh: the other half's sum, for rh = 1
      const double other = __shfl_xor_sync(FULL, run, 1);
      const double pre = rh ? other : 0.0;
      // e^{cum} of each row once: q takes the row before's, k_in the
      // reciprocal
      double ex[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ex[i] = exp_scan(pre + loc[i], etab);
      const double ex_other = __shfl_xor_sync(FULL, ex[7], 1);
      double ep = rh ? ex_other : 1.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * rh + i;
        qs[t * QS + kc] = (double)sr[t * FS + kc] * ep;
        kis[t * QS + kc] = (double)sk[t * FS + kc] * __drcp_rn(ex[i]);
        ep = ex[i];
      }
      if (rh) eend[kc] = ex[7];
      // the bonus's sum over the warp's 16 columns (lane bits 1-4): each
      // exchange halves the rows a lane keeps, the last sums the one left
      double b4[4], b2[2];
      const bool x4 = lane & 16, x3 = lane & 8, x2 = lane & 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b4[e] = (x4 ? bon[4 + e] : bon[e]) +
                __shfl_xor_sync(FULL, x4 ? bon[e] : bon[4 + e], 16);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b2[e] = (x3 ? b4[2 + e] : b4[e]) +
                __shfl_xor_sync(FULL, x3 ? b4[e] : b4[2 + e], 8);
      double b1 = (x2 ? b2[1] : b2[0]) +
                  __shfl_xor_sync(FULL, x2 ? b2[0] : b2[1], 4);
      b1 += __shfl_xor_sync(FULL, b1, 2);
      // lane holds row 8 rh + 4 x4 + 2 x3 + x2 over the warp's columns
      if (!(lane & 2))
        bpart[warp * CHUNK + 8 * rh + (x4 ? 4 : 0) + (x3 ? 2 : 0) +
              (x2 ? 1 : 0)] = b1;
    }
    PH(0);
    __syncthreads();   // (b)
    issue(ch + 2);     // into the slot chunk ch - 1 used, read by all now
    PH(1);

    // ---- A = q k_in^T, its two 16 x 8 column tiles (s 0-7, 8-15), two
    // chains each; strictly causal, the bonus on the diagonal
    for (int tile = warp; tile < 2; tile += NW) {
      double acc[2][4] = {};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const double* qa = qs + g * QS + 8 * i + j;
        const double* kb = kis + (8 * tile + g) * QS + 8 * i + j;
        const double a[4] = {qa[0], qa[8 * QS], qa[4], qa[8 * QS + 4]};
        const double bb[2] = {kb[0], kb[4]};
        mma_k8(acc[i & 1], a, bb);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = g + 8 * (m >> 1), s = 8 * tile + 2 * j + (m & 1);
        double a = 0.0;
        if (s < t) {
          a = acc[0][m] + acc[1][m];
        } else if (s == t) {
          for (int w = 0; w < NW; ++w) a += bpart[w * CHUNK + t];
        }
        ah[t * AS + s] = a;
      }
    }
    PH(2);
    cp_async_wait<1>();   // chunk ch + 1's rows: this thread's copies
    __syncthreads();      // (c): A written; chunk ch + 1 staged
    PH(3);

    // ---- warp w: y^T rows v = 16w..16w+15 of the chunk, then its state
    // rows.  v^T as the A operand: v[j + 4 (m >> 1)][16 w + g + 8 (m & 1)]
    double av[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      av[m] = (double)sv[(j + 4 * (m >> 1)) * FS + v0 + g + 8 * (m & 1)];
    double ya[2][4] = {}, yb[2][4] = {};
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const double* ab = ah + (8 * tt + g) * AS + j;   // B[s][t] = A[t][s]
      const double bb[4] = {ab[0], ab[4], ab[8], ab[12]};
      mma_k16(ya[tt], av, bb);
    }
    // q S: tile i of S^T as the A operand, its inner index j <-> k = 8i +
    // 2j, j + 4 <-> k = 8i + 2j + 1 (any order of an inner index gives the
    // same sum); B[k][t] = q[8 tt + t][k], two adjacent doubles
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const double a[4] = {st[i][0], st[i][2], st[i][1], st[i][3]};
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const double2 qb = *reinterpret_cast<const double2*>(
            qs + (8 * tt + g) * QS + 8 * i + 2 * j);
        const double bb[2] = {qb.x, qb.y};
        mma_k8(i & 1 ? yb[tt] : ya[tt], a, bb);
      }
    }
    const long long t0 = (long long)ch * CHUNK;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        yp[(t0 + 8 * tt + 2 * j + (m & 1)) * sy_.t + v0 + g + 8 * (m >> 1)] =
            (float)(ya[tt][m] + yb[tt][m]);
    PH(4);

    // S^T = (S^T + v^T k_in) diag(e^{cum_end}): B[s][k] = k_in[s][8i + k]
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const double* kb = kis + j * QS + 8 * i + g;
      const double bb[4] = {kb[0], kb[4 * QS], kb[8 * QS], kb[12 * QS]};
      mma_k16(st[i], av, bb);
      const double e0 = eend[8 * i + 2 * j], e1 = eend[8 * i + 2 * j + 1];
      st[i][0] *= e0;
      st[i][1] *= e1;
      st[i][2] *= e0;
      st[i][3] *= e1;
    }
    PH(5);
  }
  PH_FLUSH();

#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      s_fin[(long long)bh * K * K + (8 * i + 2 * j + (m & 1)) * K + v0 + g +
            8 * (m >> 1)] = (float)st[i][m];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* s_fin, int B,
           int H, int T, const Strides* st, int aligned,
           cudaStream_t stream) {
  auto kernel = rwkv6_scan_kernel<K>;
  const size_t smem = Smem<K>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B * H, Smem<K>::NT, smem, stream>>>(
      r, k, v, lw, u, s0, y, s_fin, H, T, st[0], st[1], st[2], st[3], st[4],
      aligned);
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
  // 16-byte row copies where every row of r, k, v and logw starts on 16
  int aligned = 1;
  const void* ins[4] = {r, k, v, logw};
  for (int i = 0; i < 4; ++i) {
    aligned &= ((unsigned long long)ins[i] % 16) == 0;
    for (int d = 0; d < 3; ++d) aligned &= strides[3 * i + d] % 4 == 0;
  }
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *lf = (const float*)logw,
              *uf = (const float*)u, *sf = (const float*)s0;
  float *yf = (float*)y, *of = (float*)s_fin;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 16:
      return launch<16>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, aligned,
                        s);
    case 32:
      return launch<32>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, aligned,
                        s);
    case 64:
      return launch<64>(rf, kf, vf, lf, uf, sf, yf, of, B, H, T, st, aligned,
                        s);
    default: return (int)cudaErrorInvalidValue;
  }
}
