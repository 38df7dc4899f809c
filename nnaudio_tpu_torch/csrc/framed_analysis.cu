// Framed analysis kernels for Hopper (sm_90a) on the CUDA cores: the fused
// power + filterbank projection (K2) and the fused Griffin-Lim analysis step
// (K4). The magnitude (K1) and the plain pair (K5), which used to share
// `analysis_tile` with them, run on the tensor cores in framed_tc.cu.
//
// Replaces nnaudio_tpu/ops/framed_matmul.py:
//   K2  _filterbank_kernel  (launched by _framed_filterbank)
//   K4  _gl_step_kernel     (launched by _framed_gl_step)
//
// Both compute, for the cos and sin bases (F, N) and a signal x (B, L),
//   re[b,f,t] = sum_k x[b, t*hop + k] * wcos[f,k]
//   im[b,f,t] = sum_k x[b, t*hop + k] * wsin[f,k]
// as an implicit-im2col tiled GEMM: a frame is a strided read of the signal,
// so any hop >= 1 works and no frame tensor ever exists in device memory.
// They differ only in the epilogue applied to the (re, im) register tile:
// - K2 adds eps to the power tile and projects it onto the filterbank inside
//   the block: out[b,m,t] = sum_f fb[m,f] * (re^2 + im^2 + eps). The (B,F,T)
//   power never reaches device memory.
// - K4 is one Griffin-Lim iteration's analysis half. With r = (re, -im),
//   n = r - mom * p and c = S * n * rsqrt(|n|^2 + 1e-32), it stores the next
//   loop carries c_re, c_im, r_re, r_im in the carry type C (fp32 or bf16),
//   reading p and S at the same (b,f,t) in the same thread. It works on the
//   true (B,F,T) carries and masks the ragged tile edge: no padded carries,
//   no phantom frames. It writes fresh outputs (r is not written over p).
//
// Bounds on the H100, from 4*B*T*F*N flops:
// - K2 at the classifier front end (B=32, T=626, F=513, M=64, N=1024):
//   43.4 GFLOP over ~27 MB.
// - K4 at the mel -> audio step (B=32, T=862, F=513, N=1024): 57.96 GFLOP
//   over the signal, the bases, S (fp32) and 2 carries in, 4 out (~243 MB
//   with bf16 storage and carries).
// These kernels run FMA on the CUDA cores with fp32 accumulation, at about a
// third of the 67 TFLOP/s that the H100 SXM publishes for fp32 outside the
// tensor cores; against the tensor-core peaks (495 TFLOP/s TF32, 989 bf16),
// which are what the card could do for the same work, K2 is operation-bound
// and the bf16 K4 byte-bound. Each block stages a BK-deep chunk of its frame
// tile and both basis tiles in shared memory once, and every thread then
// runs a 4x4 register micro-tile of both accumulators, i.e. 32 FMAs per 12
// shared loads. The bases are read once per (frame tile, batch) block and
// stay in L2 across blocks. The tensor-core main loop of framed_tc.cu is
// the next step for both.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode);
// every product accumulates in fp32. Launchers return cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BT = 64;   // frames per block tile
constexpr int BF = 64;   // bins per block tile
constexpr int BK = 16;   // K (frame sample) chunk staged per step
constexpr int TM = 4;    // frames per thread
constexpr int TN = 4;    // bins per thread
constexpr int FC = 16;   // filterbank rows staged per projection step (K2)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct FrontSmem {
  float a[BK][BT + 1];   // frame tile, k-major; +1 breaks bank conflicts
  float wc[BK][BF + 1];  // cos basis tile
  float ws[BK][BF + 1];  // sin basis tile
};

// re/im for frames t0 + tx + 16*i and bins f0 + ty + 16*j, where
// tx = threadIdx.x % 16 and ty = threadIdx.x / 16.
template <typename S>
__device__ __forceinline__ void analysis_tile(
    const S* __restrict__ xb, const S* __restrict__ wcos,
    const S* __restrict__ wsin, int N, int hop, int F, int T, int t0, int f0,
    FrontSmem& sm, float (&re)[TM][TN], float (&im)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lk = tid % BK, lr = tid / BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int k = k0 + lk;
    // consecutive threads read consecutive samples of one frame
#pragma unroll
    for (int r = lr; r < BT; r += NT / BK) {
      const int t = t0 + r;
      sm.a[lk][r] = (t < T && k < N) ? to_f(xb[(long long)t * hop + k]) : 0.f;
    }
#pragma unroll
    for (int r = lr; r < BF; r += NT / BK) {
      const int f = f0 + r;
      const bool ok = f < F && k < N;
      const long long o = (long long)f * N + k;
      sm.wc[lk][r] = ok ? to_f(wcos[o]) : 0.f;
      sm.ws[lk][r] = ok ? to_f(wsin[o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TN], s[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.a[kk][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[j] = sm.wc[kk][ty + 16 * j];
        s[j] = sm.ws[kk][ty + 16 * j];
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
}

// K2: grid (ceil(T/BT), ceil(M/(16*MJ)), B). A block owns one frame tile of
// one batch item and 16*MJ mels; it walks every bin tile itself, so the sum
// over F needs no atomics and is deterministic. fbT is the (F, M) transpose.
template <typename S, int MJ>
__global__ void __launch_bounds__(NT) filterbank_kernel(
    const S* __restrict__ x, const S* __restrict__ wcos,
    const S* __restrict__ wsin, const S* __restrict__ fbT,
    float* __restrict__ out, int L, int N, int hop, int F, int T, int M,
    float eps) {
  constexpr int MB = 16 * MJ;
  __shared__ FrontSmem sm;
  __shared__ float ps[BF][BT + 1];  // power tile, bin-major
  __shared__ float fbs[FC][MB];     // filterbank chunk, bin-major
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BT, m0 = blockIdx.y * MB;
  const S* xb = x + (long long)b * L;

  float acc[MJ][TM];
#pragma unroll
  for (int j = 0; j < MJ; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[j][i] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BF) {
    float re[TM][TN], im[TM][TN];
    analysis_tile<S>(xb, wcos, wsin, N, hop, F, T, t0, f0, sm, re, im);
    // eps joins the power before the projection: it contributes
    // eps * sum_f fb[m,f]. Bins past F meet zero filterbank rows below.
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i)
        ps[ty + 16 * j][tx + 16 * i] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j] + eps;
    __syncthreads();
    for (int fc = 0; fc < BF; fc += FC) {
      for (int e = tid; e < FC * MB; e += NT) {
        const int fl = e / MB, m = e % MB;
        const int f = f0 + fc + fl, mm = m0 + m;
        fbs[fl][m] = (f < F && mm < M) ? to_f(fbT[(long long)f * M + mm]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int fl = 0; fl < FC; ++fl) {
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) p[i] = ps[fc + fl][tx + 16 * i];
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const float w = fbs[fl][ty + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[j][i] = fmaf(w, p[i], acc[j][i]);
        }
      }
      __syncthreads();
    }
  }

  float* ob = out + (long long)b * M * T;
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int m = m0 + ty + 16 * j;
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + tx + 16 * i;
      if (t < T) ob[(long long)m * T + t] = acc[j][i];
    }
  }
}

// K4: grid (ceil(T/BT), ceil(F/BF), B). S is the signal/basis storage type,
// C the carry type; mag (the target magnitudes) is fp32.
template <typename S, typename C>
__global__ void __launch_bounds__(NT) gl_step_kernel(
    const S* __restrict__ x, const S* __restrict__ wcos,
    const S* __restrict__ wsin, const float* __restrict__ mag,
    const C* __restrict__ p_re, const C* __restrict__ p_im,
    C* __restrict__ c_re, C* __restrict__ c_im, C* __restrict__ r_re,
    C* __restrict__ r_im, int L, int N, int hop, int F, int T, float mom) {
  __shared__ FrontSmem sm;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BT, f0 = blockIdx.y * BF;
  float re[TM][TN], im[TM][TN];
  analysis_tile<S>(x + (long long)b * L, wcos, wsin, N, hop, F, T, t0, f0, sm,
                   re, im);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long base = (long long)b * F * T;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int f = f0 + ty + 16 * j;
    if (f >= F) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + tx + 16 * i;
      if (t >= T) continue;
      const long long o = base + (long long)f * T + t;
      const float rr = re[i][j], ri = -im[i][j];  // reference sign convention
      const float nr = rr - mom * to_f(p_re[o]);
      const float ni = ri - mom * to_f(p_im[o]);
      const float scale = mag[o] * rsqrtf(nr * nr + ni * ni + 1e-32f);
      store(c_re + o, nr * scale);
      store(c_im + o, ni * scale);
      store(r_re + o, rr);
      store(r_im + o, ri);
    }
  }
}

template <typename S, int MJ>
cudaError_t launch_filterbank_mj(const void* x, const void* wcos,
                                 const void* wsin, const void* fbT, void* out,
                                 int B, int L, int N, int hop, int F, int T,
                                 int M, float eps, cudaStream_t st) {
  const dim3 grid((T + BT - 1) / BT, (M + 16 * MJ - 1) / (16 * MJ), B);
  filterbank_kernel<S, MJ><<<grid, NT, 0, st>>>(
      static_cast<const S*>(x), static_cast<const S*>(wcos),
      static_cast<const S*>(wsin), static_cast<const S*>(fbT),
      static_cast<float*>(out), L, N, hop, F, T, M, eps);
  return cudaGetLastError();
}

// the smallest register tile that holds all M mels; past 256 mels the grid
// takes further mel chunks, each recomputing its power tiles
template <typename S>
cudaError_t launch_filterbank(const void* x, const void* wcos, const void* wsin,
                              const void* fbT, void* out, int B, int L, int N,
                              int hop, int F, int T, int M, float eps,
                              cudaStream_t st) {
  if (M <= 16)
    return launch_filterbank_mj<S, 1>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T, M, eps, st);
  if (M <= 32)
    return launch_filterbank_mj<S, 2>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T, M, eps, st);
  if (M <= 64)
    return launch_filterbank_mj<S, 4>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T, M, eps, st);
  if (M <= 128)
    return launch_filterbank_mj<S, 8>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T, M, eps, st);
  return launch_filterbank_mj<S, 16>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T, M, eps, st);
}

template <typename S, typename C>
cudaError_t launch_gl_step(const void* x, const void* wcos, const void* wsin,
                           const void* mag, const void* p_re, const void* p_im,
                           void* c_re, void* c_im, void* r_re, void* r_im,
                           int B, int L, int N, int hop, int F, int T,
                           float mom, cudaStream_t st) {
  const dim3 grid((T + BT - 1) / BT, (F + BF - 1) / BF, B);
  gl_step_kernel<S, C><<<grid, NT, 0, st>>>(
      static_cast<const S*>(x), static_cast<const S*>(wcos),
      static_cast<const S*>(wsin), static_cast<const float*>(mag),
      static_cast<const C*>(p_re), static_cast<const C*>(p_im),
      static_cast<C*>(c_re), static_cast<C*>(c_im), static_cast<C*>(r_re),
      static_cast<C*>(r_im), L, N, hop, F, T, mom);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_gl_step_carry(const void* x, const void* wcos,
                                 const void* wsin, const void* mag,
                                 const void* p_re, const void* p_im,
                                 void* c_re, void* c_im, void* r_re,
                                 void* r_im, int B, int L, int N, int hop,
                                 int F, int T, float mom, int carry_bf16,
                                 cudaStream_t st) {
  if (carry_bf16)
    return launch_gl_step<S, __nv_bfloat16>(x, wcos, wsin, mag, p_re, p_im,
                                            c_re, c_im, r_re, r_im, B, L, N,
                                            hop, F, T, mom, st);
  return launch_gl_step<S, float>(x, wcos, wsin, mag, p_re, p_im, c_re, c_im,
                                  r_re, r_im, B, L, N, hop, F, T, mom, st);
}

}  // namespace

extern "C" int nnaudio_framed_filterbank(const void* x, const void* wcos,
                                         const void* wsin, const void* fbT,
                                         void* out, int B, int L, int N,
                                         int hop, int F, int T, int M,
                                         float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_filterbank<__nv_bfloat16>(x, wcos, wsin, fbT, out, B, L, N,
                                            hop, F, T, M, eps, st);
  return launch_filterbank<float>(x, wcos, wsin, fbT, out, B, L, N, hop, F, T,
                                  M, eps, st);
}

extern "C" int nnaudio_gl_step(const void* x, const void* wcos,
                               const void* wsin, const void* mag,
                               const void* p_re, const void* p_im, void* c_re,
                               void* c_im, void* r_re, void* r_im, int B,
                               int L, int N, int hop, int F, int T, float mom,
                               int bf16, int carry_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_gl_step_carry<__nv_bfloat16>(
        x, wcos, wsin, mag, p_re, p_im, c_re, c_im, r_re, r_im, B, L, N, hop,
        F, T, mom, carry_bf16, st);
  return launch_gl_step_carry<float>(x, wcos, wsin, mag, p_re, p_im, c_re,
                                     c_im, r_re, r_im, B, L, N, hop, F, T,
                                     mom, carry_bf16, st);
}
