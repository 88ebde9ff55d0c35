// FP64 rates of one H100 for the RWKV-6 scan kernel's design: the tensor
// core's double products (mma.sync m8n8k4, and sm_90's m16n8k4, m16n8k8,
// m16n8k16), the vector DFMA, and the double exponential (CUDA's exp and
// the scan kernel's own, rwkv6_scan.cu::exp_scan).  Each rate kernel runs
// ILP independent chains per thread for `iters` steps over the grid the
// caller picks; the layout kernels compute one product through the
// fragment layouts the scan kernel assumes, so the caller can hold them
// against a product on the host.  Built by benchmarks/torch_fp64_rates.py.
#include "../../src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"

namespace {

template <int SHAPE>
struct Frag;
// m8n8k4: a 1, b 1, c 2 doubles a lane
template <>
struct Frag<0> {
  static constexpr int A = 1, B = 1, C = 2, FMA = 8 * 8 * 4;
  __device__ static void mma(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%0, %1};\n"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a[0]), "d"(b[0]));
  }
};
// m16n8k4: a 2, b 1, c 4
template <>
struct Frag<1> {
  static constexpr int A = 2, B = 1, C = 4, FMA = 16 * 8 * 4;
  __device__ static void mma(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
// m16n8k8: a 4, b 2, c 4
template <>
struct Frag<2> {
  static constexpr int A = 4, B = 2, C = 4, FMA = 16 * 8 * 8;
  __device__ static void mma(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
// m16n8k16: a 8, b 4, c 4
template <>
struct Frag<3> {
  static constexpr int A = 8, B = 4, C = 4, FMA = 16 * 8 * 16;
  __device__ static void mma(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

template <int SHAPE, int ILP>
__global__ void mma_rate(const double* __restrict__ in,
                         double* __restrict__ out, int iters) {
  using F = Frag<SHAPE>;
  double a[F::A], b[F::B], c[ILP][F::C];
  for (int i = 0; i < F::A; ++i) a[i] = in[(threadIdx.x + i) & 63];
  for (int i = 0; i < F::B; ++i) b[i] = in[(threadIdx.x + 7 * i) & 63];
  for (int l = 0; l < ILP; ++l)
    for (int i = 0; i < F::C; ++i) c[l][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int l = 0; l < ILP; ++l) F::mma(c[l], a, b);
  double s = 0.0;
  for (int l = 0; l < ILP; ++l)
    for (int i = 0; i < F::C; ++i) s += c[l][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int ILP>
__global__ void dfma_rate(const double* __restrict__ in,
                          double* __restrict__ out, int iters) {
  double x[ILP];
  const double a = in[threadIdx.x & 63], b = in[(threadIdx.x + 1) & 63];
  for (int l = 0; l < ILP; ++l) x[l] = in[(threadIdx.x + l) & 63];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int l = 0; l < ILP; ++l) x[l] = fma(x[l], a, b);
  double s = 0.0;
  for (int l = 0; l < ILP; ++l) s += x[l];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int OWN>
__global__ void exp_rate(const double* __restrict__ in,
                         double* __restrict__ out, int iters) {
  constexpr int ILP = 8;
  __shared__ double tab[64];
  for (int e = threadIdx.x; e < 64; e += blockDim.x)
    tab[e] = exp2((double)e / 64.0);
  __syncthreads();
  double x[ILP], s = 0.0;
  for (int l = 0; l < ILP; ++l) x[l] = -0.5 * in[(threadIdx.x + l) & 63];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int l = 0; l < ILP; ++l) {
      const double e = OWN ? exp_scan(x[l], tab) : exp(x[l]);
      s += e;
      x[l] = x[l] * 0.999;
    }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One product C = A B through the assumed fragment layouts (lane g =
// lane / 4, j = lane % 4): A (M x K) and B (K x 8) row-major in, C (M x 8)
// row-major out.
template <int SHAPE>
__global__ void mma_layout(const double* __restrict__ A,
                           const double* __restrict__ B,
                           double* __restrict__ C) {
  using F = Frag<SHAPE>;
  constexpr int K = F::FMA / ((SHAPE == 0 ? 8 : 16) * 8);
  const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
  double a[F::A], b[F::B], c[F::C] = {};
  for (int i = 0; i < F::A; ++i)
    a[i] = A[(g + 8 * (i & 1)) * K + j + 4 * (i >> 1)];
  if (SHAPE == 0) a[0] = A[g * K + j];
  for (int i = 0; i < F::B; ++i) b[i] = B[(j + 4 * i) * 8 + g];
  F::mma(c, a, b);
  for (int i = 0; i < F::C; ++i)
    C[(g + 8 * (i >> 1)) * 8 + 2 * j + (i & 1)] = c[i];
}

}  // namespace

// which: 0-3 mma shapes (ilp 1, 4 or 8), 4 dfma (ilp 1 or 8), 5 CUDA exp,
// 6 the scan kernel's exp.  Launches grid x block threads.
extern "C" int fp64_rate(int which, int ilp, int grid, int block,
                         const void* in, void* out, int iters,
                         void* stream) {
  const double* i = (const double*)in;
  double* o = (double*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define RATE(K, SH)                                                        \
  if (ilp == 1) K<SH, 1><<<grid, block, 0, s>>>(i, o, iters);              \
  else if (ilp == 4) K<SH, 4><<<grid, block, 0, s>>>(i, o, iters);         \
  else K<SH, 8><<<grid, block, 0, s>>>(i, o, iters);
  switch (which) {
    case 0: RATE(mma_rate, 0) break;
    case 1: RATE(mma_rate, 1) break;
    case 2: RATE(mma_rate, 2) break;
    case 3: RATE(mma_rate, 3) break;
    case 4:
      if (ilp == 1) dfma_rate<1><<<grid, block, 0, s>>>(i, o, iters);
      else dfma_rate<8><<<grid, block, 0, s>>>(i, o, iters);
      break;
    case 5: exp_rate<0><<<grid, block, 0, s>>>(i, o, iters); break;
    case 6: exp_rate<1><<<grid, block, 0, s>>>(i, o, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RATE
  return (int)cudaGetLastError();
}

extern "C" int fp64_mma_layout(int shape, const void* a, const void* b,
                               void* c, void* stream) {
  const double *ad = (const double*)a, *bd = (const double*)b;
  double* cd = (double*)c;
  cudaStream_t s = (cudaStream_t)stream;
  switch (shape) {
    case 0: mma_layout<0><<<1, 32, 0, s>>>(ad, bd, cd); break;
    case 1: mma_layout<1><<<1, 32, 0, s>>>(ad, bd, cd); break;
    case 2: mma_layout<2><<<1, 32, 0, s>>>(ad, bd, cd); break;
    case 3: mma_layout<3><<<1, 32, 0, s>>>(ad, bd, cd); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
