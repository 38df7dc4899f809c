// Split-K framed magnitude / power for Hopper (sm_90a): the giant-bank
// kernel (K6).
//
// Replaces nnaudio_tpu/ops/framed_matmul.py _magnitude_kchunk_kernel
// (launched by _framed_magnitude_kchunk, planned by _plan_kchunk). It
// computes the same function as K1 (framed_tc.cu, MAGNITUDE / POWER),
//   re[b,f,t] = sum_k x[b, t*hop + k] * wcos[f,k]      (im with wsin)
//   out[b,f,t] = sqrt(re^2 + im^2 + eps), or the power itself when `square`,
// for a bank of few bins (F <= 128) and a long contraction (N in the
// thousands): CQT1992v2's 84 wavelets of 16384 samples.
//
// What K1 lacks at that shape is parallelism and tile fit: its grid is
// (frame tiles) x (64-bin tiles) x B blocks that each walk all of N, so one
// 10 s clip is 14 blocks on 132 SMs, and the second bin tile of 84 bins is
// mostly padding. Here a block owns one batch item, 64 frames, ALL bins and
// one contiguous range of K:
// - the bin tile is 16*TN wide with TN in {2, 4, 6, 8} chosen from F, so 84
//   bins run in a 96-wide tile;
// - the K axis is cut into `splits` ranges of `kper` samples (a multiple of
//   BK; the last range may be shorter and is masked). The wrapper chooses
//   the split count from the shapes alone, so that the grid fills the card;
// - with one split the block applies the epilogue itself and the arithmetic
//   is K1's: one sequential fp32 FMA chain per output. With more, each block
//   stores its partial re and im into an fp32 workspace (splits, B, F, T),
//   and a second kernel sums the splits in index order and applies the
//   epilogue. No atomics: the result is deterministic.
//
// Bound on the H100: 4*B*T*F*N flops. At the CQT default (B=32, T=431, F=84,
// N=16384, hop 512) that is 75.9 GFLOP over ~46 MB (signal, two banks,
// output), about 1600 flop/byte: operation-bound, 1.13 ms at the published
// 67 TFLOP/s fp32 peak of the H100 SXM outside the tensor cores (700 W
// limit). The kernel runs fp32 FMA on the CUDA cores. Each thread keeps a
// 4 x TN register tile of both accumulators and reads its 4 frames as one
// float4 and its bins as float2s from shared memory (neighbouring threads
// share them, so the reads broadcast): 8*TN FMAs per 1 + TN shared loads.
// The workspace adds 2 * splits * B*F*T * 4 bytes written and read once,
// small beside the operations. The wavelets' zero columns are multiplied
// like any other; tensor cores (wgmma) and TMA are not used here.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode);
// every product accumulates in fp32. The launcher returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BT = 64;   // frames per block tile
constexpr int BK = 16;   // K (frame sample) chunk staged per step
constexpr int TM = 4;    // frames per thread, contiguous
constexpr int PAD = 4;   // row padding: spreads the staging stores over the
                         // banks and keeps every row 16-byte aligned

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int TN>
struct __align__(16) KchunkSmem {
  float a[BK][BT + PAD];        // frame tile, k-major
  float wc[BK][16 * TN + PAD];  // cos bank tile
  float ws[BK][16 * TN + PAD];  // sin bank tile
};

// grid (ceil(T/BT), splits, B). Thread (tx, ty) = (tid % 16, tid / 16) owns
// frames t0 + 4*tx + i and bins TN*ty + j. PARTIAL stores the raw sums of
// this block's K range into the workspace; otherwise the block covers all of
// K and stores the finished magnitude or power.
template <typename S, int TN, bool PARTIAL>
__global__ void __launch_bounds__(NT) kchunk_kernel(
    const S* __restrict__ x, const S* __restrict__ wcos,
    const S* __restrict__ wsin, float* __restrict__ out_re,
    float* __restrict__ out_im, int L, int N, int hop, int F, int T, int kper,
    float eps, int square) {
  constexpr int BF = 16 * TN;
  __shared__ KchunkSmem<TN> sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lk = tid % BK, lr = tid / BK;
  const int b = blockIdx.z, split = blockIdx.y;
  const int t0 = blockIdx.x * BT;
  const int kbeg = split * kper;
  const int kend = min(N, kbeg + kper);
  const S* xb = x + (long long)b * L;

  float re[TM][TN], im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int k = k0 + lk;
    const bool kok = k < kend;
    // consecutive threads read consecutive samples of one frame / one bin
#pragma unroll
    for (int r = lr; r < BT; r += NT / BK) {
      const int t = t0 + r;
      sm.a[lk][r] = (kok && t < T) ? to_f(xb[(long long)t * hop + k]) : 0.f;
    }
#pragma unroll
    for (int r = lr; r < BF; r += NT / BK) {
      const bool ok = kok && r < F;
      const long long o = (long long)r * N + k;
      sm.wc[lk][r] = ok ? to_f(wcos[o]) : 0.f;
      sm.ws[lk][r] = ok ? to_f(wsin[o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][TM * tx]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      float c[TN], s[TN];
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const float2 cv = *reinterpret_cast<const float2*>(&sm.wc[kk][TN * ty + j]);
        const float2 sv = *reinterpret_cast<const float2*>(&sm.ws[kk][TN * ty + j]);
        c[j] = cv.x;
        c[j + 1] = cv.y;
        s[j] = sv.x;
        s[j + 1] = sv.y;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
  }

  const long long plane = (long long)F * T;
  const long long base =
      (PARTIAL ? (long long)split * gridDim.z + b : (long long)b) * plane;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int f = TN * ty + j;
    if (f >= F) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + TM * tx + i;
      if (t >= T) continue;
      const long long o = base + (long long)f * T + t;
      if (PARTIAL) {
        out_re[o] = re[i][j];
        out_im[o] = im[i][j];
      } else {
        const float p = re[i][j] * re[i][j] + im[i][j] * im[i][j] + eps;
        out_re[o] = square ? p : sqrtf(p);
      }
    }
  }
}

// Second pass: the splits summed in index order, then the epilogue. One
// thread per output element, grid-stride.
__global__ void __launch_bounds__(NT) kchunk_reduce_kernel(
    const float* __restrict__ ws_re, const float* __restrict__ ws_im,
    float* __restrict__ out, long long n, int splits, float eps, int square) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    float re = 0.f, im = 0.f;
    for (int s = 0; s < splits; ++s) {
      re += ws_re[(long long)s * n + o];
      im += ws_im[(long long)s * n + o];
    }
    const float p = re * re + im * im + eps;
    out[o] = square ? p : sqrtf(p);
  }
}

template <typename S, int TN>
cudaError_t launch_tn(const void* x, const void* wcos, const void* wsin,
                      void* out, void* ws_re, void* ws_im, int B, int L, int N,
                      int hop, int F, int T, int splits, int kper, float eps,
                      int square, cudaStream_t st) {
  const dim3 grid((T + BT - 1) / BT, splits, B);
  const S* xs = static_cast<const S*>(x);
  const S* wc = static_cast<const S*>(wcos);
  const S* wsn = static_cast<const S*>(wsin);
  if (splits == 1) {
    kchunk_kernel<S, TN, false><<<grid, NT, 0, st>>>(
        xs, wc, wsn, static_cast<float*>(out), nullptr, L, N, hop, F, T, kper,
        eps, square);
    return cudaGetLastError();
  }
  kchunk_kernel<S, TN, true><<<grid, NT, 0, st>>>(
      xs, wc, wsn, static_cast<float*>(ws_re), static_cast<float*>(ws_im), L,
      N, hop, F, T, kper, eps, square);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)B * F * T;
  const long long want = (n + NT - 1) / NT;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  kchunk_reduce_kernel<<<blocks, NT, 0, st>>>(
      static_cast<const float*>(ws_re), static_cast<const float*>(ws_im),
      static_cast<float*>(out), n, splits, eps, square);
  return cudaGetLastError();
}

// the narrowest bin tile that holds all F <= 128 bins
template <typename S>
cudaError_t launch(const void* x, const void* wcos, const void* wsin, void* out,
                   void* ws_re, void* ws_im, int B, int L, int N, int hop,
                   int F, int T, int splits, int kper, float eps, int square,
                   cudaStream_t st) {
  if (F <= 32)
    return launch_tn<S, 2>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop, F, T, splits, kper, eps, square, st);
  if (F <= 64)
    return launch_tn<S, 4>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop, F, T, splits, kper, eps, square, st);
  if (F <= 96)
    return launch_tn<S, 6>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop, F, T, splits, kper, eps, square, st);
  return launch_tn<S, 8>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop, F, T, splits, kper, eps, square, st);
}

}  // namespace

// out (B, F, T) fp32; ws_re / ws_im (splits, B, F, T) fp32, unused (may be
// null) when splits == 1. kper is the K range of one split: a multiple of
// 16 with (splits - 1) * kper < N <= splits * kper.
extern "C" int nnaudio_framed_magnitude_kchunk(
    const void* x, const void* wcos, const void* wsin, void* out, void* ws_re,
    void* ws_im, int B, int L, int N, int hop, int F, int T, int splits,
    int kper, float eps, int square, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > 128 || splits < 1 || kper < 1 || kper % BK != 0 ||
      (long long)(splits - 1) * kper >= N || (long long)splits * kper < N)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop,
                                 F, T, splits, kper, eps, square, st);
  return launch<float>(x, wcos, wsin, out, ws_re, ws_im, B, L, N, hop, F, T,
                       splits, kper, eps, square, st);
}
