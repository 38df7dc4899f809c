// Synthesis + overlap-add kernel for Hopper (sm_90a): the iSTFT hot path (K3).
//
// Replaces nnaudio_tpu/ops/framed_matmul.py _synthesis_ola_kernel (launched
// by _synthesis_ola). Computes, for spectra Re/Im (B, F, T) and kernels
// kc/ks (F, N) that already carry window, 1/N and Hermitian fold weights,
//   y[b, t*hop + j] += sum_f kc[f,j] * Re[b,f,t] - ks[f,j] * Im[b,f,t]
// into y (B, N + hop*(T-1)), with no window normalisation.
//
// Output-stationary. View y as rows of `hop` samples, y[r*hop + p]. Frame t
// contributes to row r through its chunk c = r - t (j = c*hop + p < N), so
//   y[r*hop + p] = sum_c sum_f kc[f, c*hop + p] * Re[f, r-c] - ks[...] * Im[...]
// A block owns (b, 64 rows x 64 columns of that view): a set of output
// samples that is one contiguous range when hop <= 64. It loops over the
// chunks c whose frames touch its rows and over F in shared-memory chunks of
// Re, Im, kc and ks, and writes each of its samples exactly once. There are
// no atomics, the sum is deterministic, and there is no tile-boundary tail
// to fold back or phase recombination to do. Any hop >= 1 works: columns
// past `hop`, and kernel samples past N, are masked.
//
// Bound on the H100: 4*B*T*F*N flops against (2*B*F*T + 2*F*N + B*len) * 4
// bytes. At the headline (B=32, T=431, F=1025, N=2048) that is 115.8 GFLOP
// over ~158 MB: compute-bound. The kernel runs fp32 FMA on the CUDA cores
// (ceiling: the H100 SXM's published 67 TFLOP/s fp32 at its 700 W limit, a
// 1.73 ms bound at the headline); each thread keeps a 4x4
// register tile and does 32 FMAs per 16 shared loads. Tensor cores are the
// next step and are not used here.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode);
// every product accumulates in fp32. The launcher returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BR = 64;   // output rows per block
constexpr int BP = 64;   // output columns (samples within a row) per block
constexpr int BK = 16;   // bins staged per step
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ceil(R/BR), ceil(hop/BP), B) with R = T + n_chunks - 1 rows
template <typename S>
__global__ void __launch_bounds__(NT) synthesis_ola_kernel(
    const S* __restrict__ sre, const S* __restrict__ sim,
    const S* __restrict__ kc, const S* __restrict__ ks, float* __restrict__ y,
    int F, int T, int N, int hop, int n_chunks, int length) {
  __shared__ float are[BK][BR + 1];  // Re[f][r - c], bin-major
  __shared__ float aim[BK][BR + 1];
  __shared__ float bc[BK][BP + 1];   // kc[f][c*hop + p]
  __shared__ float bs[BK][BP + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // tx: columns, ty: rows
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * BR, p0 = blockIdx.y * BP;
  const S* reb = sre + (long long)b * F * T;
  const S* imb = sim + (long long)b * F * T;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    // frames r - c of this block's rows must exist, and the chunk's first
    // kernel sample must lie inside the frame; both are block-uniform
    if (r0 + BR - 1 - c < 0 || r0 - c > T - 1) continue;
    if (c * hop + p0 >= N) continue;
    for (int f0 = 0; f0 < F; f0 += BK) {
      // spectra: consecutive threads read consecutive frames of one bin
      for (int e = tid; e < BK * BR; e += NT) {
        const int fl = e / BR, r = e % BR;
        const int f = f0 + fl, t = r0 + r - c;
        const bool ok = f < F && t >= 0 && t < T;
        const long long o = (long long)f * T + t;
        are[fl][r] = ok ? to_f(reb[o]) : 0.f;
        aim[fl][r] = ok ? to_f(imb[o]) : 0.f;
      }
      // kernels: consecutive threads read consecutive samples of one bin
      for (int e = tid; e < BK * BP; e += NT) {
        const int fl = e / BP, p = e % BP;
        const int f = f0 + fl, q = p0 + p, j = c * hop + q;
        const bool ok = f < F && q < hop && j < N;
        const long long o = (long long)f * N + j;
        bc[fl][p] = ok ? to_f(kc[o]) : 0.f;
        bs[fl][p] = ok ? to_f(ks[o]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int fl = 0; fl < BK; ++fl) {
        float ar[TM], ai[TM], wc[TN], ws[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          ar[i] = are[fl][ty + 16 * i];
          ai[i] = aim[fl][ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          wc[j] = bc[fl][tx + 16 * j];
          ws[j] = bs[fl][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(ar[i], wc[j], acc[i][j]);
            acc[i][j] = fmaf(-ai[i], ws[j], acc[i][j]);
          }
      }
      __syncthreads();
    }
  }

  float* yb = y + (long long)b * length;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = p0 + tx + 16 * j;
      if (q >= hop) continue;
      const long long s = r * hop + q;
      if (s < length) yb[s] = acc[i][j];
    }
  }
}

template <typename S>
cudaError_t launch(const void* sre, const void* sim, const void* kc,
                   const void* ks, void* y, int B, int F, int T, int N,
                   int hop, cudaStream_t st) {
  const int n_chunks = (N + hop - 1) / hop;
  const int rows = T + n_chunks - 1;
  const int length = N + hop * (T - 1);
  const dim3 grid((rows + BR - 1) / BR, (hop + BP - 1) / BP, B);
  synthesis_ola_kernel<S><<<grid, NT, 0, st>>>(
      static_cast<const S*>(sre), static_cast<const S*>(sim),
      static_cast<const S*>(kc), static_cast<const S*>(ks),
      static_cast<float*>(y), F, T, N, hop, n_chunks, length);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nnaudio_synthesis_ola(const void* sre, const void* sim,
                                     const void* kc, const void* ks, void* y,
                                     int B, int F, int T, int N, int hop,
                                     int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(sre, sim, kc, ks, y, B, F, T, N, hop, st);
  return launch<float>(sre, sim, kc, ks, y, B, F, T, N, hop, st);
}
