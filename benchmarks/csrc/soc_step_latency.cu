// Latency of the operations on the soc_step episode kernel's dependent
// chain, measured with clock64() over long chains of dependent operations
// in one warp: float add, multiply, IEEE division, the kernel's own
// branch-free division (qdiv), tmin and xla_log (this file includes the kernel's source, so the device
// functions are the ones the kernel runs), a shared-memory load (pointer
// chasing), __shfl_sync and __syncwarp.  Built with the kernel's flags
// (--fmad=false) by benchmarks/torch_soc_step_phases.py --latency.
#include "../../src/repro_torch/kernels/soc_step/csrc/soc_step.cu"

namespace {

constexpr int CHAIN = 4096;
enum { L_ADD = 0, L_MUL, L_DIV, L_LOG, L_TMIN, L_SMEM, L_SHFL, L_SYNC,
       L_QDIV, N_LAT };

__global__ void __launch_bounds__(32)
latency_kernel(const float* __restrict__ in, long long* __restrict__ out,
               float* __restrict__ sink) {
  __shared__ int chase[CHAIN];
  const int lane = threadIdx.x;
  for (int i = lane; i < CHAIN; i += 32) chase[i] = (i + 33) % CHAIN;
  __syncwarp();
  const float a = in[0], b = in[1];
  float x = in[2];
  long long t0, t1;
  float acc = 0.0f;
#define TIME_CHAIN(slot, body)                                   \
  t0 = clock64();                                                \
  for (int i = 0; i < CHAIN; ++i) { body; }                      \
  t1 = clock64();                                                \
  if (lane == 0) out[slot] = t1 - t0;                            \
  acc = acc + x;
  x = in[2];
  TIME_CHAIN(L_ADD, x = x + a)
  x = in[2];
  TIME_CHAIN(L_MUL, x = x * b)
  x = in[2];
  TIME_CHAIN(L_DIV, x = x / b)
  x = in[2];
  TIME_CHAIN(L_LOG, x = xla_log(x) + 2.0f)
  x = in[2];
  TIME_CHAIN(L_TMIN, x = tmin(x, a))
  unsigned bad = 0u;
  x = in[2];
  TIME_CHAIN(L_QDIV, x = qdiv(x, b, bad))
  acc = acc + (float)bad;
  int idx = lane;
  t0 = clock64();
  for (int i = 0; i < CHAIN; ++i) idx = chase[idx];
  t1 = clock64();
  if (lane == 0) out[L_SMEM] = t1 - t0;
  int v = lane;
  t0 = clock64();
  for (int i = 0; i < CHAIN; ++i) v = __shfl_sync(0xffffffffu, v, (lane + 1) & 31);
  t1 = clock64();
  if (lane == 0) out[L_SHFL] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < CHAIN; ++i) {
    chase[lane] = v + i;
    __syncwarp();
    v = chase[(lane + 1) & 31];
  }
  t1 = clock64();
  if (lane == 0) out[L_SYNC] = t1 - t0;
#undef TIME_CHAIN
  sink[lane] = acc + (float)idx + (float)v;
}

// The step's building blocks on one real row (consts and a packed xf row
// staged in shared memory), each called BLOCK_REPS times in a dependent
// chain (a result feeds the next call's load sums), in one warp: the four
// modes' timing with the branch-free and with IEEE division, the reward,
// the selection, and the (14, 16, 16, 4) sense network's forward and TD
// update (weights from a formula).
constexpr int BLOCK_REPS = 256;
enum { B_TIMING_FAST = 0, B_TIMING_EXACT, B_REWARD_FAST, B_SELECT,
       B_FORWARD, B_TD_UPDATE, N_BLOCKS };

__global__ void __launch_bounds__(32)
block_kernel(const float* __restrict__ consts, const float* __restrict__ row,
             int n_consts, int nf, int n_tiles, int T, int F,
             long long* __restrict__ out, float* __restrict__ sink) {
  __shared__ float c[64];
  __shared__ float xr[256];
  __shared__ float ex[64];
  const int lane = threadIdx.x;
  for (int i = lane; i < n_consts; i += 32) c[i] = consts[i];
  for (int i = lane; i < nf; i += 32) xr[i] = row[i];
  for (int i = lane; i < 64; i += 32) ex[i] = 1e30f;
  __syncwarp();
  Step x;
  x.fp = xr[0];
  x.eps = xr[1];
  x.alpha = xr[2];
  x.u = xr[3];
  x.tiles = xr + 4;
  x.others = xr + 4 + n_tiles;
  x.profile = xr + 4 + n_tiles + T;
  x.avail = x.profile + F;
  x.g_pick = x.avail + N_MODES;
  x.g_tie = x.g_pick + N_MODES;
  x.acc = 0;
  x.thread = 0;
  x.fresh = 0;
  x.valid = 1;
  x.pre_mode = 0;
  float load = 0.01f, acc = 0.0f;
  long long t0, t1;
  FastDiv fd;
  ExactDiv ed;
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i) {
    Timing tm = invocation_timing<false>(fd, lane & 3, c, x, 0.5f, 2.0f,
                                          load, load, load, load);
    load = 0.01f + tm.exec_time * 1e-30f;
  }
  t1 = clock64();
  if (lane == 0) out[B_TIMING_FAST] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i) {
    Timing tm = invocation_timing<false>(ed, lane & 3, c, x, 0.5f, 2.0f,
                                          load, load, load, load);
    load = 0.01f + tm.exec_time * 1e-30f;
  }
  t1 = clock64();
  if (lane == 0) out[B_TIMING_EXACT] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i) {
    Reward rw = evaluate_reward(fd, c, ex, 1, 0, x.fp, 1000.0f + load,
                                500.0f, 800.0f, 20.0f);
    load = 0.01f + rw.reward * 1e-30f;
  }
  t1 = clock64();
  if (lane == 0) out[B_REWARD_FAST] = t1 - t0;
  float rsel[N_MODES] = {1.0f, 1.0f, 0.5f, 0.25f};
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i) {
    const int a = select_action(rsel, x, true);
    rsel[0] = rsel[0] + (float)a * 1e-30f;
  }
  t1 = clock64();
  if (lane == 0) out[B_SELECT] = t1 - t0;
  // the sense network: pack rows 15 + 17 + 17, 16 columns
  __shared__ float wpack[49 * 16], hbuf[14 + 16 + 16 + 4],
      gbuf[2 * MAX_WIDTH];
  for (int i = lane; i < 49 * 16; i += 32)
    wpack[i] = 0.01f * (float)((i * 7) % 13) - 0.05f;
  for (int i = lane; i < 14; i += 32) hbuf[i] = 0.1f * (float)i;
  Mlp m;
  m.w = wpack;
  m.h = hbuf;
  m.g = gbuf;
  m.n_dims = 4;
  m.d[0] = 14; m.d[1] = 16; m.d[2] = 16; m.d[3] = 4; m.d[4] = 0;
  m.cols = 16;
  m.onehot = false;
  m.qfun = 1.0f;
  m.lr = 0.05f;
  __syncwarp();
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i) {
    mlp_forward_warp(m, lane);
    if (lane == 0) hbuf[0] = hbuf[0] + hbuf[46] * 1e-30f;
    __syncwarp();
  }
  t1 = clock64();
  if (lane == 0) out[B_FORWARD] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < BLOCK_REPS; ++i)
    mlp_td_update_warp(m, lane, i & 3, 0.5f, 1e-6f, true);
  t1 = clock64();
  if (lane == 0) out[B_TD_UPDATE] = t1 - t0;
  sink[lane] = load + acc + rsel[0] + (fd.ok() ? 0.0f : 1.0f) + wpack[lane];
}

}  // namespace

// out[N_BLOCKS] cycles over BLOCK_REPS dependent calls of each building
// block of the step, on the row `row` (nf floats) and the consts row.
extern "C" int soc_step_block_latency(const float* consts_host,
                                      const float* row_host, int n_consts,
                                      int nf, int n_tiles, int T, int F,
                                      long long* out_host, int* reps) {
  float *d_c, *d_r, *d_sink;
  long long* d_out;
  cudaMalloc(&d_c, n_consts * sizeof(float));
  cudaMalloc(&d_r, nf * sizeof(float));
  cudaMalloc(&d_sink, 32 * sizeof(float));
  cudaMalloc(&d_out, N_BLOCKS * sizeof(long long));
  cudaMemcpy(d_c, consts_host, n_consts * sizeof(float),
             cudaMemcpyHostToDevice);
  cudaMemcpy(d_r, row_host, nf * sizeof(float), cudaMemcpyHostToDevice);
  for (int rep = 0; rep < 2; ++rep)
    block_kernel<<<1, 32>>>(d_c, d_r, n_consts, nf, n_tiles, T, F, d_out,
                            d_sink);
  cudaError_t e = cudaMemcpy(out_host, d_out, N_BLOCKS * sizeof(long long),
                             cudaMemcpyDeviceToHost);
  cudaFree(d_c);
  cudaFree(d_r);
  cudaFree(d_sink);
  cudaFree(d_out);
  *reps = BLOCK_REPS;
  return (int)e;
}

// out[N_LAT] cycles over CHAIN dependent operations each; returns the CUDA
// error of the launch and the copy.
extern "C" int soc_step_latency(long long* out_host, int* chain_len) {
  float h_in[3] = {1.0000001f, 0.99999994f, 3.0f};
  float *d_in, *d_sink;
  long long* d_out;
  cudaMalloc(&d_in, sizeof h_in);
  cudaMalloc(&d_sink, 32 * sizeof(float));
  cudaMalloc(&d_out, N_LAT * sizeof(long long));
  cudaMemcpy(d_in, h_in, sizeof h_in, cudaMemcpyHostToDevice);
  for (int rep = 0; rep < 2; ++rep)   // the first run warms the caches
    latency_kernel<<<1, 32>>>(d_in, d_out, d_sink);
  cudaError_t e = cudaMemcpy(out_host, d_out, N_LAT * sizeof(long long),
                             cudaMemcpyDeviceToHost);
  cudaFree(d_in);
  cudaFree(d_sink);
  cudaFree(d_out);
  *chain_len = CHAIN;
  return (int)e;
}
