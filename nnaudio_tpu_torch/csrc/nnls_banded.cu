// The inverse Mel's NNLS on Hopper (sm_90a): for every (batch, time) column
// of a mel spectrogram, the estimate s >= 0 of the power spectrum that
// minimises ||M s - mel||^2, by projected gradient with a fixed step:
//   s = relu(pinv(M) mel), then n_iter times s = relu(s - step M^T (M s - mel)).
//
// Replaces no TPU kernel: the JAX package's NNLS
// (nnaudio_tpu/features/inverse_mel.py, mel_to_power) is plain einsum
// products that XLA compiles. The port's plain route (ops/framed_kernels.py,
// nnls_plain) runs the same loop as 1 + 2 n_iter dense fp32 products through
// cuBLAS and four ATen passes a step, so s (B, F, T) goes to device memory
// and back every step, through products that are 98% zeros (a Slaney mel
// basis of 80 x 513 holds 727 nonzero entries).
//
// What bounds it on the H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 on the CUDA
// cores): at the inversion cell's shape (B=32, M=80, F=513, T=862, 727
// nonzero entries, 64 steps) the least bytes are M, pinv(M) and mel read once
// and s written once, 65.8 MB: 19.6 us; the least operations are 7.40 GFLOP
// (the dense seed 2.26, then 4 a nonzero entry and a column each step,
// 5.13): 14.9 us at the TF32 rate, 110 us at the fp32 rate of the CUDA cores.
// Neither is what bounds this kernel: each term of a step reads one word of
// s or of the residual from shared memory, so the steps move about 3,500
// warp-wide words a block and step through the SM's shared-memory port (128
// bytes a clock), ~0.75 ms at that shape; the chains of dependent loads keep
// it from that (below).
//
// Design:
// - Two kernels on the stream, one launch of the wrapper. The seed is a
//   dense product with pinv(M), which is not banded (164 KB at the cell's
//   shape): a block that owned 32 columns would read all of it for them, some
//   140 GB of L2 traffic in all. So nnls_banded_seed_kernel computes it as a
//   tiled product, 64 bins x 64 columns a block with the whole contraction
//   (M <= 128 rows) in shared memory, each thread 4 bins x 4 columns, an fp32
//   FMA chain over m from 0, and writes relu of it to the output. Then
//   nnls_banded_kernel runs every step of a block's columns on chip.
// - A block of the steps owns 32 columns of one batch item along T, one to a
//   lane, in 16 warps: T is contiguous, so the loads of mel and s and the
//   store of s coalesce. Its shared memory holds s of the basis's active bins
//   [fa, fa + nf) as [f][32] and the residual r as [m][32] (a warp reads a row
//   of 32 neighbouring words: no bank conflicts), the basis twice as bands
//   (per row of M the range of its nonzero columns, per active bin the range
//   of its nonzero rows, each an int4 header read by one broadcast, then
//   their entries; a bin of at most two rows, every bin of a triangular mel
//   basis, holds its entries in its header), and each warp keeps its rows'
//   mel in registers. A bin outside the active range has a zero column in M:
//   its gradient is 0 and its s is the seed, which the seed kernel wrote.
// - Each step: the warps take the rows in turn (row m to warp m mod 16) and
//   form r = M s - mel; a barrier; the warps take the active bins in turn,
//   two at a time (bins f and f + 16), and form s = relu(s - step M^T r); a
//   barrier. s is read from device memory once, at the start, and written
//   once, at the end. The step count is an argument of the launch.
// - What paces the steps is latency: a bin's header, then its rows' r, then
//   its update, each a round trip to shared memory, at 32 warps an SM (64
//   registers a thread). Builds timed on an H100 at the cell's shape: 8
//   warps a block 2.64 ms, 16 warps 2.04, the bins' entries in their headers
//   and two bins an iteration 1.69; four bins an iteration (1.82), two rows
//   an iteration (1.69), the rows' headers in registers (2.09) and loads
//   predicated to fixed groups of four (3.36) gained nothing.
// - Fixed summation order, no atomics: every run gives the same bits. A
//   band's terms go into four partial sums by index mod 4, each in order,
//   then (s0 + s1) + (s2 + s3), as K2's FFT route projects; s - step g is
//   rounded twice. ops/framed_kernels.py's nnls_banded_plain repeats this
//   arithmetic in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;           // columns of a block of the steps: one to a lane
constexpr int WARPS = 16;          // warps of a block of the steps
constexpr int ROWS_PER_WARP = 8;   // mel rows a warp keeps in registers, at most
constexpr int MAX_M = WARPS * ROWS_PER_WARP;
constexpr int SEED_F = 64;         // bins of a block of the seed
constexpr int SEED_T = 64;         // columns of a block of the seed
constexpr int SEED_THREADS = 256;  // 16 x 16 threads of 4 x 4 outputs
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;

size_t seed_smem_bytes(int M) {
  return sizeof(float) * static_cast<size_t>(M) * (SEED_F + SEED_T);
}

size_t step_smem_bytes(int nf, int M, int nnz) {
  return sizeof(float) * COLS * (static_cast<size_t>(nf) + M) +
         sizeof(int4) * (static_cast<size_t>(M) + nf) + sizeof(float) * static_cast<size_t>(nnz);
}

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// out[b, f, t] = relu(sum_m pinv[f, m] mel[b, m, t]) for a tile of SEED_F
// bins and SEED_T columns: pinv(M) transposed (M, F) and mel (B, M, T) staged
// whole along m in shared memory.
__global__ void __launch_bounds__(SEED_THREADS)
    nnls_banded_seed_kernel(const float* __restrict__ mel, const float* __restrict__ pinv_t,
                            float* __restrict__ out, int M, int F, int T) {
  extern __shared__ float4 seed_smem[];
  float* a = reinterpret_cast<float*>(seed_smem);  // [M][SEED_F]
  float* x = a + M * SEED_F;                       // [M][SEED_T]
  const int t0 = blockIdx.x * SEED_T, f0 = blockIdx.y * SEED_F, b = blockIdx.z;
  const float* mb = mel + static_cast<long long>(b) * M * T;
  for (int i = threadIdx.x; i < M * SEED_F; i += SEED_THREADS) {
    const int m = i / SEED_F, f = f0 + i % SEED_F;
    a[i] = f < F ? pinv_t[static_cast<long long>(m) * F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < M * SEED_T; i += SEED_THREADS) {
    const int m = i / SEED_T, t = t0 + i % SEED_T;
    x[i] = t < T ? mb[static_cast<long long>(m) * T + t] : 0.f;
  }
  __syncthreads();
  // bins 4 ty + i, columns tx + 16 j: a warp's stores of one bin are 16
  // neighbouring columns
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m = 0; m < M; ++m) {
    const float4 w = *reinterpret_cast<const float4*>(a + m * SEED_F + 4 * ty);
    const float wv[4] = {w.x, w.y, w.z, w.w};
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = x[m * SEED_T + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], v[j], acc[i][j]);
  }
  float* ob = out + static_cast<long long>(b) * F * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      if (f < F && t < T) ob[static_cast<long long>(f) * T + t] = relu(acc[i][j]);
    }
  }
}

// sum_j v[h.z + j] * x[(h.x + j) * COLS + lane] for j < h.y: four partial
// sums by j mod 4, each in order, then (s0 + s1) + (s2 + s3).
__device__ __forceinline__ float band_sum(int4 h, const float* v, const float* x, int lane) {
  const float* vv = v + h.z;
  const float* xx = x + h.x * COLS + lane;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= h.y; j += 4) {
    a0 = fmaf(vv[j], xx[j * COLS], a0);
    a1 = fmaf(vv[j + 1], xx[(j + 1) * COLS], a1);
    a2 = fmaf(vv[j + 2], xx[(j + 2) * COLS], a2);
    a3 = fmaf(vv[j + 3], xx[(j + 3) * COLS], a3);
  }
  if (j < h.y) a0 = fmaf(vv[j], xx[j * COLS], a0);
  if (j + 1 < h.y) a1 = fmaf(vv[j + 1], xx[(j + 1) * COLS], a1);
  if (j + 2 < h.y) a2 = fmaf(vv[j + 2], xx[(j + 2) * COLS], a2);
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

// The gradient of one bin from its header: (first row, length, its two
// entries' bits) for at most two rows, else (first row, length, offset of its
// entries in cv, 0).
__device__ __forceinline__ float col_sum(int4 h, const float* cv, const float* r, int lane) {
  if (h.y > 2) return band_sum(h, cv, r, lane);
  const float* rr = r + h.x * COLS + lane;
  const float a0 = h.y > 0 ? __fmul_rn(__int_as_float(h.z), rr[0]) : 0.f;
  const float a1 = h.y > 1 ? __fmul_rn(__int_as_float(h.w), rr[COLS]) : 0.f;
  return __fadd_rn(a0, a1);
}

// Every step of 32 columns of one batch item, in place on out, which holds
// the seed: band is (M + nf) int4, per row of M (lo - fa, length, offset, 0),
// then per active bin as col_sum reads it; vals the rows' nnz_r entries, then
// the bins'.
__global__ void __launch_bounds__(COLS * WARPS, 2)
    nnls_banded_kernel(const float* __restrict__ mel, const int4* __restrict__ band,
                       const float* __restrict__ vals, float* __restrict__ out, int M, int F,
                       int T, int fa, int nf, int nnz_r, int nnz, float step, int n_iter) {
  extern __shared__ float4 step_smem[];
  float* s = reinterpret_cast<float*>(step_smem);      // [nf][COLS]
  float* r = s + nf * COLS;                            // [M][COLS]
  int4* rows = reinterpret_cast<int4*>(r + M * COLS);  // M, then the bins' nf
  const int4* bins = rows + M;
  float* rv = reinterpret_cast<float*>(rows + M + nf);  // nnz_r, then the bins'
  const float* cv = rv + nnz_r;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y, t = blockIdx.x * COLS + lane;
  const bool live = t < T;
  for (int i = threadIdx.x; i < M + nf; i += COLS * WARPS) rows[i] = band[i];
  for (int i = threadIdx.x; i < nnz; i += COLS * WARPS) rv[i] = vals[i];
  float* col = out + (static_cast<long long>(b) * F + fa) * T + t;
  for (int f = warp; f < nf; f += WARPS)
    s[f * COLS + lane] = live ? col[static_cast<long long>(f) * T] : 0.f;
  const float* mcol = mel + static_cast<long long>(b) * M * T + t;
  float mv[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int m = warp + WARPS * i;
    mv[i] = live && m < M ? mcol[static_cast<long long>(m) * T] : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int m = warp + WARPS * i;
      if (m < M) r[m * COLS + lane] = __fsub_rn(band_sum(rows[m], rv, s, lane), mv[i]);
    }
    __syncthreads();
    for (int f = warp; f < nf; f += 2 * WARPS) {
      const int f2 = f + WARPS;
      const bool two = f2 < nf;
      const int4 h1 = bins[f];
      const int4 h2 = two ? bins[f2] : h1;
      const float s1 = s[f * COLS + lane];
      const float s2 = two ? s[f2 * COLS + lane] : 0.f;
      const float g1 = col_sum(h1, cv, r, lane);
      const float g2 = col_sum(h2, cv, r, lane);
      s[f * COLS + lane] = relu(__fsub_rn(s1, __fmul_rn(step, g1)));
      if (two) s[f2 * COLS + lane] = relu(__fsub_rn(s2, __fmul_rn(step, g2)));
    }
    __syncthreads();
  }
  if (live)
    for (int f = warp; f < nf; f += WARPS) col[static_cast<long long>(f) * T] = s[f * COLS + lane];
}

// The kernel's shared-memory limit raised once per device, where it asks for
// more than the default 48 KB.
cudaError_t open_smem(const void* kernel, size_t bytes, bool* opened) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opened[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opened[dev] = true;
  }
  return cudaSuccess;
}

bool takes(int nf, int M, int nnz) {
  return M >= 1 && M <= MAX_M && nf >= 0 && nnz >= 0 &&
         step_smem_bytes(nf, M, nnz) <= static_cast<size_t>(SMEM_LIMIT);
}

}  // namespace

// out (B, F, T) fp32 <- the NNLS of mel (B, M, T) fp32 over a basis M (M, F):
// the seed from pinv_t, pinv(M) transposed (M, F), then n_iter steps of
// `step` over the bands of ops/framed_kernels.py's NNLSPlan (band, vals; the
// active bins [fa, fa + nf), the rows' nnz_r entries of nnz). Returns a
// cudaError_t.
extern "C" int nnaudio_nnls_banded(const void* mel, const void* pinv_t, const void* band,
                                   const void* vals, void* out, int B, int M, int F, int T,
                                   int fa, int nf, int nnz_r, int nnz, float step, int n_iter,
                                   void* stream) {
  if (B < 1 || B > 65535 || F < 1 || T < 1 || fa < 0 || fa + nf > F || nnz_r < 0 ||
      nnz_r > nnz || n_iter < 0 || !takes(nf, M, nnz))
    return cudaErrorInvalidValue;
  static bool seed_opened[MAX_DEVICES], step_opened[MAX_DEVICES];
  const float* ms = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t seed_bytes = seed_smem_bytes(M);
  cudaError_t err = open_smem(reinterpret_cast<const void*>(nnls_banded_seed_kernel),
                              seed_bytes, seed_opened);
  if (err != cudaSuccess) return err;
  const dim3 seed_grid((T + SEED_T - 1) / SEED_T, (F + SEED_F - 1) / SEED_F, B);
  nnls_banded_seed_kernel<<<seed_grid, SEED_THREADS, seed_bytes, st>>>(
      ms, static_cast<const float*>(pinv_t), o, M, F, T);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_iter == 0 || nf == 0) return err;
  const size_t bytes = step_smem_bytes(nf, M, nnz);
  err = open_smem(reinterpret_cast<const void*>(nnls_banded_kernel), bytes, step_opened);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + COLS - 1) / COLS, B);
  nnls_banded_kernel<<<grid, COLS * WARPS, bytes, st>>>(
      ms, static_cast<const int4*>(band), static_cast<const float*>(vals), o, M, F, T, fa, nf,
      nnz_r, nnz, step, n_iter);
  return cudaGetLastError();
}

// The shared memory of a block of the steps for nf active bins, M rows and
// nnz band entries in all, or 0 where the kernel cannot run them: M outside
// [1, 128] (a warp keeps its rows' mel in registers), or a block that would
// pass the H100's 227 KB.
extern "C" int nnaudio_nnls_banded_smem(int nf, int M, int nnz) {
  return takes(nf, M, nnz) ? static_cast<int>(step_smem_bytes(nf, M, nnz)) : 0;
}
