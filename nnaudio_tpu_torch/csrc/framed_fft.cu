// K2's FFT route on Hopper (sm_90a): for a frozen Fourier basis, a real FFT
// of each frame, its power and a banded filterbank projection in one pass,
// on the CUDA cores. K3's FFT route, the inverse real FFT of each frame and
// its overlap-add, shares the passes and the twiddle table (below the
// analysis kernel).
//
// Stands beside nnaudio_tpu/ops/framed_matmul.py:
//   K2  _filterbank_kernel  :296  (launched by _framed_filterbank)
// which computes the pair as a dense product with the bases, as the port's
// dense K2 (framed_tc.cu FILTERBANK) does. Where the pair is the windowed DFT
// of its window w = wcos[0] (ops/framed_kernels.py, build_fft_plan, checks
// every entry once per basis), this kernel computes
//   out[b,m,t] = sum_f fb[m,f] * (|rfft(w * x[b, t*hop : t*hop + N])[f]|^2 + eps)
// for fp32 storage and N a power of two in [64, 8192], with no (B, F, T)
// tensor, no workspace and no second kernel; N = 2^a 5^b there takes the
// mixed-radix kernel further down. Any other basis keeps the dense
// tensor-core K2 (framed_tc.cu FILTERBANK).
//
// What bounds it on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s
// HBM): at the Mel defaults (B=32, T=431, N=2048, M=128, 2,018 nonzero
// filterbank entries) a frame takes ~5 N/2 log2(N/2) operations of complex
// FFT, ~20 a pair of bins to unpack and square, 2 per nonzero entry: ~0.8
// GFLOP a call, 12 us at the fp32 peak; the signal read once and the output
// written once are 35.3 MB, 10.5 us. Neither is reached (~0.067 ms): a frame
// crosses shared memory twice in the FFT and once each to unpack and to
// project, at two blocks of 128-register threads an SM, and the time goes to
// those passes' latency and to the banded projection's rows of unequal
// length (builds without each part, timed on an H100: the passes after the
// first ~0.014 ms, the projection ~0.016, the frames' loads ~0.010).
//
// Design:
// - Frames are the flattened (b, t) index. A block takes FPB frames at a
//   time (C where that is enough to give every resident block some: a stream
//   step's few frames), every gridDim.x FPB frames, in rounds of C frames in
//   flight, one frame to a team of P = N/64 threads. A frame's arithmetic
//   does not depend on which block, team or round takes it, so the result
//   does not depend on B, T or the batch's split into stream steps.
// - The real FFT is an N/2-point complex FFT of z[j] = (w x)[2j] + i (w x)[2j+1]
//   by Stockham passes of radix 32 (the last one fewer where log2(N/2)
//   asks). Each thread holds 32 points in registers, turns them by the
//   pass's twiddles (a table built in float64 on the host, stored as fp32;
//   W_32's constants are the same values), runs a radix-2
//   decimation-in-frequency DFT on them and, after its team's barrier,
//   writes them to their places in natural order in the team's buffer in
//   shared memory, with a pad after every 16 points so that the strided
//   accesses fall on distinct banks. The first pass reads its points from
//   device memory, windowed on the way; the team's next frame is read while
//   the block projects the frames before it. Then each pair of bins f and
//   N/2 - f is unpacked from Z[f] and Z[N/2 - f] (E = Z[f] + conj Z[N/2-f],
//   O = Z[f] - conj Z[N/2-f]: bin f is E - i W_N^f O, bin N/2 - f is
//   E + i W_N^f O) and squared; the power goes back into the buffer.
// - The projection reads the filterbank as bands: per row the range of its
//   nonzero columns and their values (2,018 entries for Slaney mel-128 at
//   n_fft 2048, not 131,200), kept in shared memory where they fit; a dense
//   filterbank has full-width bands. A thread takes one row of FG = 2
//   frames at a time (at the Mel defaults rows m and m + 64: a short band
//   beside a long one), each row's terms summed in four partial sums by
//   index mod 4, each in order, then (s0 + s1) + (s2 + s3). Rows of the block's frames go to a
//   tile in shared memory, written to (B, M, T) once the block's FPB frames
//   are done: a row in runs of FPB frames (64 bytes) where the frames of a
//   batch item lie side by side.
// - Fixed summation order, no atomics: every run gives the same bits.
// ops/framed_kernels.py's framed_filterbank_fft_plain repeats this
// arithmetic in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RADIX = 32;         // points a thread holds in a pass
constexpr int MAX_THREADS = 256;  // threads of a block, at most
constexpr int MAX_TEAMS = 32;     // frames in flight in a block, at most
constexpr int RUN = 16;           // frames a block takes at a time where the grid is full
constexpr int MIN_BLOCKS = 2;     // blocks an SM holds at least: at most 128 registers
constexpr int PROJECT_FRAMES = 2; // frames a thread projects at once, at most
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

template <int LOG2H>
struct Shape {
  static constexpr int H = 1 << LOG2H;            // complex points of a frame
  static constexpr int N = 2 * H;                 // samples of a frame
  static constexpr int P = H / RADIX;             // threads of a frame's team
  static constexpr int C = MAX_THREADS / P < MAX_TEAMS ? MAX_THREADS / P : MAX_TEAMS;
  static constexpr int THREADS = P * C;           // threads of a block
  static constexpr int LOG2C = ilog2(C);          // C frames in flight in a block
  static constexpr int FPB = C > RUN ? C : RUN;   // frames of a block, at most
  static constexpr int FG = C < PROJECT_FRAMES ? C : PROJECT_FRAMES;  // frames a thread projects
  static constexpr int STRIDE = H + H / 16 + 1;   // float2 of a frame's buffer
};

// Where a pass's twiddles start in the table (ops/framed_kernels.py,
// fft_twiddles): after the N/2 + 1 of the unpacking, Ns (R - 1) for each
// earlier pass with Ns > 1; at ns_log = LOG2H, the table's length.
__host__ __device__ constexpr int pass_offset(int log2h, int ns_log) {
  int at = (1 << log2h) + 1;
  for (int s = 0; s < ns_log;) {
    const int rlog = log2h - s < ilog2(RADIX) ? log2h - s : ilog2(RADIX);
    if (s > 0) at += (1 << s) * ((1 << rlog) - 1);
    s += rlog;
  }
  return at;
}

// Shared memory of a block: the destination offsets of the FPB frames it
// takes at a time, the C frames in flight, the output tile, the bands'
// ranges, and (vals > 0) the bands' entries.
template <int LOG2H>
constexpr size_t smem_bytes(int m, int vals) {
  using S = Shape<LOG2H>;
  return 8 * S::FPB + 8 * S::C * S::STRIDE + 4 * static_cast<size_t>(m) * S::FPB +
         4 * (2 * static_cast<size_t>(m) + 1) + 4 * static_cast<size_t>(vals);
}

__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// pad16(i + q * STEP), with pad16(i) given: folded where STEP is a multiple
// of 16
template <int STEP>
__device__ __forceinline__ int pad16_add(int i, int padded, int q) {
  if constexpr (STEP % 16 == 0) return padded + q * (STEP + STEP / 16);
  else return pad16(i + q * STEP);
}

// The barrier of a frame's team of P threads: named barrier 1 + team where
// a team is several warps of a block of several teams, the block's or the
// warp's own where it is the block or lies inside one warp.
template <int P, int THREADS>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (P >= THREADS) {
    __syncthreads();
  } else if constexpr (P > 32) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(P) : "memory");
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// cos(2 pi t / 32) for t in [0, 8] in fp32, each rounded once from float64
// as the host's twiddle table holds them (tests/test_torch_fft_filterbank.py
// holds the two equal)
__device__ __forceinline__ constexpr float cos32(int t) {
  return t == 0 ? 1.0f
       : t == 1 ? 0x1.f6297cp-1f
       : t == 2 ? 0x1.d906bcp-1f
       : t == 3 ? 0x1.a9b662p-1f
       : t == 4 ? 0x1.6a09e6p-1f
       : t == 5 ? 0x1.1c73b4p-1f
       : t == 6 ? 0x1.87de2ap-2f
       : t == 7 ? 0x1.8f8b84p-3f
       : 0.0f;
}

// W_32^t = exp(-2 pi i t / 32) for t in [0, 16)
__device__ __forceinline__ constexpr float2 w32(int t) {
  return t <= 8 ? float2{cos32(t), -cos32(8 - t)} : float2{-cos32(16 - t), -cos32(t - 8)};
}

template <int BITS>
__device__ __forceinline__ int bitrev(int q) {
  return static_cast<int>(__brev(static_cast<unsigned>(q)) >> (32 - BITS));
}

// R points in registers -> their DFT, v[s] holding output bitrev(s):
// radix 2, decimation in frequency, from the widest half (HALF = R / 2) to
// the narrowest; d * W_2half^i is d * W_32^(16i/half), a swap for -i.
template <int R, int HALF = R / 2>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float2 a = v[b + i], c = v[b + i + HALF];
        v[b + i] = make_float2(a.x + c.x, a.y + c.y);
        const float2 d = make_float2(a.x - c.x, a.y - c.y);
        const int t = i * (16 / HALF);
        v[b + i + HALF] = t == 0 ? d : t == 8 ? make_float2(d.y, -d.x) : cmul(d, w32(t));
      }
    }
    dft<R, HALF / 2>(v);
  }
}

// v[r] (r < R) of the butterfly j of a pass with Ns = 2^NS_LOG, after its
// DFT, to its places (j / Ns) Ns R + j % Ns + q Ns in z; Ns is 1 (the first
// pass, whose radix is RADIX) or a multiple of 16.
template <int RLOG, int NS_LOG>
__device__ __forceinline__ void put(float2* z, int j, const float2 (&v)[1 << RLOG]) {
  constexpr int R = 1 << RLOG, NS = 1 << NS_LOG;
  static_assert(NS == 1 ? R == RADIX : NS % 16 == 0, "padded strides");
  const int base = ((j >> NS_LOG) << (NS_LOG + RLOG)) + (j & (NS - 1));
  const int pb = pad16(base);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int q = bitrev<RLOG>(s);
    z[NS == 1 ? pb + pad16(q) : pb + q * (NS + NS / 16)] = v[s];
  }
}

// The Stockham passes after the first, from Ns = 2^NS_LOG on, on the team's
// buffer z; thread p of the team takes the butterflies j = p + q P. Each
// pass ends at the team's barrier.
template <int LOG2H, int NS_LOG>
__device__ __forceinline__ void fft_passes(float2* z, int p, int team,
                                           const float2* __restrict__ twiddle) {
  if constexpr (NS_LOG < LOG2H) {
    using S = Shape<LOG2H>;
    constexpr int RLOG = LOG2H - NS_LOG < ilog2(RADIX) ? LOG2H - NS_LOG : ilog2(RADIX);
    constexpr int R = 1 << RLOG, NS = 1 << NS_LOG, M = S::H / R, NB = RADIX / R;
    const float2* ptw = twiddle + pass_offset(LOG2H, NS_LOG);
    float2 v[NB][R];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int j = p + q * S::P, pj = pad16(j);
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = z[pad16_add<M>(j, pj, r)];
      const float2* t = ptw + (j & (NS - 1)) - NS;
#pragma unroll
      for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(t + r * NS));
      dft<R>(v[q]);
    }
    team_sync<S::P, S::THREADS>(team);
#pragma unroll
    for (int q = 0; q < NB; ++q) put<RLOG, NS_LOG>(z, p + q * S::P, v[q]);
    team_sync<S::P, S::THREADS>(team);
    fft_passes<LOG2H, NS_LOG + RLOG>(z, p, team, twiddle);
  }
}

// Thread p's points p + r H/RADIX of frame g (zeros past the frames), raw:
// the first pass reads them from device memory.
template <int LOG2H>
__device__ __forceinline__ void fetch(float2 (&v)[RADIX], const float* __restrict__ x, int g,
                                      int frames, int T, int L, int hop, int p) {
  using S = Shape<LOG2H>;
  constexpr int M = S::H / RADIX;
  const int b = g / T;
  const float* a = x + static_cast<long long>(b) * L + static_cast<long long>(g - b * T) * hop +
                   2 * p;
  const bool inside = g < frames, paired = (reinterpret_cast<uintptr_t>(a) & 7) == 0;
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    const float* c = a + 2 * r * M;
    v[r] = !inside ? make_float2(0.f, 0.f)
         : paired  ? __ldg(reinterpret_cast<const float2*>(c))
                   : make_float2(__ldg(c), __ldg(c + 1));
  }
}

// A round's C frames, their power in buf, projected onto the bands into the
// tile: a thread takes one row of FG frames; a frame's row sums its terms e
// in four partial sums by e mod 4, each in order, then (s0 + s1) + (s2 + s3).
// fbv is the bands' entries in shared memory or in device memory: each call
// is inlined with its own kind of load.
template <int LOG2H>
__device__ __forceinline__ void project(const float2* buf, const int* bands,
                                        const float* fbv, float* tile, int M, int fpb,
                                        int round) {
  using S = Shape<LOG2H>;
  constexpr int FG = S::FG, GROUPS = S::C / FG;
  for (int o = threadIdx.x; o < GROUPS * M; o += S::THREADS) {
    const int m = o / GROUPS, i0 = (o % GROUPS) * FG;
    const float* power = reinterpret_cast<const float*>(buf + i0 * S::STRIDE) + bands[m];
    const int e0 = bands[M + m], n = bands[M + m + 1] - e0;
    const float* fv = fbv + e0;
    float acc[4][FG];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < FG; ++k) acc[u][k] = 0.f;
    int e = 0;
    for (; e + 4 <= n; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = fv[e + u];
#pragma unroll
        for (int k = 0; k < FG; ++k)
          acc[u][k] = fmaf(a, power[k * 2 * S::STRIDE + e + u], acc[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (e + u < n) {
        const float a = fv[e + u];
#pragma unroll
        for (int k = 0; k < FG; ++k)
          acc[u][k] = fmaf(a, power[k * 2 * S::STRIDE + e + u], acc[u][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < FG; ++k)
      tile[m * fpb + round * S::C + i0 + k] = (acc[0][k] + acc[1][k]) + (acc[2][k] + acc[3][k]);
  }
}

template <int LOG2H>
__global__ void __launch_bounds__(Shape<LOG2H>::THREADS, MIN_BLOCKS)
framed_fft_filterbank_kernel(const float* __restrict__ x, const float* __restrict__ window,
                             const float2* __restrict__ twiddle,
                             const int* __restrict__ band, const float* __restrict__ vals,
                             float* __restrict__ out, int L, int hop, int T, int M, int nnz,
                             int frames, int rounds, float eps) {
  using S = Shape<LOG2H>;
  constexpr int MP = S::H / RADIX;  // the first pass's stride, in points
  extern __shared__ __align__(16) unsigned char smem[];
  long long* dst = reinterpret_cast<long long*>(smem);              // FPB
  float2* buf = reinterpret_cast<float2*>(dst + S::FPB);            // C frames of STRIDE
  float* tile = reinterpret_cast<float*>(buf + S::C * S::STRIDE);  // M rows of FPB
  int* bands = reinterpret_cast<int*>(tile + M * S::FPB);           // 2M + 1
  float* svals = reinterpret_cast<float*>(bands + 2 * M + 1);       // nnz, or none

  const int tid = threadIdx.x;
  const int fpb = S::C * rounds;
  const int log2fpb = __ffs(fpb) - 1;
  const int team = tid / S::P, p = tid % S::P;
  float2* z = buf + team * S::STRIDE;
  float* zp = reinterpret_cast<float*>(z);
  // the block takes fpb frames at a time, [g0, g0 + fpb), every gridDim.x
  // fpb frames; the raw points of the team's next frame are read while the
  // frames before it are projected
  float2 v[RADIX];
  fetch<LOG2H>(v, x, blockIdx.x * fpb + team, frames, T, L, hop, p);
  for (int i = tid; i < 2 * M + 1; i += S::THREADS) bands[i] = band[i];
  for (int i = tid; i < nnz; i += S::THREADS) svals[i] = vals[i];

  for (int g0 = blockIdx.x * fpb; g0 < frames; g0 += gridDim.x * fpb) {
    for (int round = 0; round < rounds; ++round) {
      // the first pass, from the points as read: windowed, its DFT, placed
#pragma unroll
      for (int r = 0; r < RADIX; ++r) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(window) + p + r * MP);
        v[r] = make_float2(v[r].x * w.x, v[r].y * w.y);
      }
      dft<RADIX>(v);
      put<ilog2(RADIX), 0>(z, p, v);
      team_sync<S::P, S::THREADS>(team);
      fft_passes<LOG2H, ilog2(RADIX)>(z, p, team, twiddle);

      // unpack and square, two bins from one pair of points: for f = p + q P
      // in [0, N/4], bin f is E - i W_N^f O and bin N/2 - f is E + i W_N^f O
      // (bin N/4 once, by thread 0)
      constexpr int PAIRS = RADIX / 2 + 1;
      float lower[PAIRS], upper[PAIRS];
      const int pp = pad16(p);
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int f = p + q * S::P;
        if (q < PAIRS - 1 || p == 0) {
          const float2 a = z[pad16_add<S::P>(p, pp, q)], c = z[pad16((S::H - f) & (S::H - 1))];
          const float er = a.x + c.x, ei = a.y - c.y;
          const float2 wo = cmul(make_float2(a.x - c.x, a.y + c.y), __ldg(twiddle + f));
          const float lr = er + wo.y, li = ei - wo.x, ur = er - wo.y, ui = ei + wo.x;
          lower[q] = (lr * lr + li * li) * 0.25f + eps;
          upper[q] = (ur * ur + ui * ui) * 0.25f + eps;
        }
      }
      team_sync<S::P, S::THREADS>(team);
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int f = p + q * S::P;
        if (q < PAIRS - 1) {
          zp[f] = lower[q];
          zp[S::H - f] = upper[q];
        } else if (p == 0) {
          zp[f] = lower[q];
        }
      }
      const int next = round + 1 < rounds ? g0 + (round + 1) * S::C : g0 + gridDim.x * fpb;
      fetch<LOG2H>(v, x, next + team, frames, T, L, hop, p);
      __syncthreads();

      if (nnz)
        project<LOG2H>(buf, bands, svals, tile, M, fpb, round);
      else
        project<LOG2H>(buf, bands, vals, tile, M, fpb, round);
      __syncthreads();
    }
    if (tid < fpb) {
      const int g = g0 + tid, b = g / T;
      dst[tid] = g < frames ? (static_cast<long long>(b) * M) * T + (g - b * T) : -1;
    }
    __syncthreads();
    for (int o = tid; o < fpb * M; o += S::THREADS) {
      const int i = o & (fpb - 1), m = o >> log2fpb;
      const long long d = dst[i];
      if (d >= 0) out[d + static_cast<long long>(m) * T] = tile[m * fpb + i];
    }
  }
}

int device_sms() {
  static int sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 132;
  if (!sms[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
    sms[dev] = n;
  }
  return sms[dev];
}

template <int LOG2H>
int launch(const float* x, const float* window, const float2* twiddle, const int* band,
           const float* vals, float* out, int B, int L, int hop, int T, int M, int nnz,
           float eps, cudaStream_t stream) {
  using S = Shape<LOG2H>;
  const long long frames = static_cast<long long>(B) * T;
  if (frames < 1 || frames > (1LL << 30) || M < 1 || nnz < 0 || hop < 1 || L < S::N)
    return cudaErrorInvalidValue;
  // the bands' entries in shared memory where two blocks still fit an SM
  size_t bytes = smem_bytes<LOG2H>(M, nnz);
  const bool vals_shared = bytes <= static_cast<size_t>(SMEM_LIMIT) / 2;
  if (!vals_shared) bytes = smem_bytes<LOG2H>(M, 0);
  if (bytes > static_cast<size_t>(SMEM_LIMIT)) return cudaErrorInvalidValue;
  // per device: the shared-memory limit raised, and the blocks an SM holds
  // at the last size asked for
  static bool opened[MAX_DEVICES];
  static size_t held_bytes[MAX_DEVICES];
  static int held[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !opened[dev]) {
    err = cudaFuncSetAttribute(framed_fft_filterbank_kernel<LOG2H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opened[dev] = true;
  }
  if (held_bytes[dev] != bytes) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, framed_fft_filterbank_kernel<LOG2H>, S::THREADS, bytes);
    if (err != cudaSuccess) return err;
    held[dev] = n > 0 ? n : 1;
    held_bytes[dev] = bytes;
  }
  // FPB frames at a time where that still gives every resident block some,
  // else C (a stream step's few frames spread over more blocks)
  const long long resident = static_cast<long long>(device_sms()) * held[dev];
  const int rounds = (frames + S::FPB - 1) / S::FPB >= resident ? S::FPB / S::C : 1;
  const int fpb = S::C * rounds;
  const long long chunks = (frames + fpb - 1) / fpb;
  const long long grid = chunks < resident ? chunks : resident;
  framed_fft_filterbank_kernel<LOG2H>
      <<<static_cast<unsigned>(grid), S::THREADS, bytes, stream>>>(
          x, window, twiddle, band, vals, out, L, hop, T, M, vals_shared ? nnz : 0,
          static_cast<int>(frames), rounds, eps);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// K2's FFT route at a mixed-radix N: N = 2^a 5^b with a >= 2 and b >= 1 in
// [64, 8192] (Whisper's 400 = 2^4 5^2 among them), the same function as the
// kernel above: the exact DFT of each windowed frame (no zero-padding), its
// power and the banded projection, one write to (B, M, T).
//
// What bounds it: at Whisper's front end (B=32, 30 s at 16 kHz, T=3,001,
// N=400, M=128, 394 nonzero filterbank entries) the signal read once and the
// output written once are 110.6 MB, 33 us at 3.35 TB/s; a frame's FFT, unpack
// and projection are ~10 k operations, ~1 GFLOP a call, 15 us on the CUDA
// cores. Neither is reached (~0.28 ms, timed on an H100): a frame crosses
// shared memory once a pass, and the instructions that load, index and store
// its points, ~1,100 a frame for a warp, outnumber its arithmetic. Builds
// with N a template parameter (each pass's constants known) were ~8% faster
// and took twice as long to compile; reading the next frame ahead during the
// projection, or into L2, and blocks of 4 or 8 frames were no faster.
//
// Design, beside the power-of-two kernel's (its loader's windowing, its
// unpack, its projection order and its output tile are repeated):
// - One frame to a warp, C warps (frames in flight) a block, C a power of two
//   in [2, 16] chosen at launch from the shared memory the frames take. The
//   warp's lanes take the butterflies j = lane + 32 q of each pass, so every
//   N of the family runs in one compiled kernel with its passes read from the
//   launch's arguments (MixedPasses): Stockham passes of radix 16, 8, 4 or 2
//   (the 2^a part, in as few passes as radix 16 allows, the larger first)
//   then of radix 5, each butterfly's points in registers, turned by the
//   pass's twiddles (the power-of-two table's layout), their DFT (the
//   power-of-two kernel's dft, or dft5 below) written to the frame's other
//   buffer: two buffers a frame, each padded after every 16 points.
// - The first pass reads the frame from device memory, windowed on the way;
//   after the last, the pairs of bins f and N/2 - f are unpacked and squared
//   into the frame's other buffer; the block projects its C frames' power
//   onto the bands as the power-of-two kernel does (two frames a thread, four
//   partial sums by index mod 4), into the output tile.
// - Fixed summation order, no atomics: every run gives the same bits, and a
//   frame's arithmetic does not depend on B, T or a stream's split.
// ops/framed_kernels.py's framed_filterbank_fft_plain repeats the radix
// order and this arithmetic in PyTorch (fft_radices, _fft_stockham).

namespace {

constexpr int MAX_PASSES = 8;    // passes of an FFT of the family, at most
constexpr int MIXED_WARPS = 16;  // frames in flight in a block, at most

// The passes of an h-point complex FFT (ops/framed_kernels.py's
// fft_radices): pass s's radix less one in bits [4s, 4s + 4) of radices.
// Pass s's twiddles start where the earlier passes' end (fft_pass_offsets):
// after the unpacking's h + 1, ns (R - 1) for each earlier pass with ns > 1
// points already combined; length is the table's.
struct MixedPasses {
  int h, count, length;
  unsigned radices;
};

__host__ __device__ __forceinline__ int radix_of(const MixedPasses& pl, int s) {
  return static_cast<int>((pl.radices >> (4 * s)) & 15u) + 1;
}

bool mixed_passes(int n, MixedPasses& pl) {
  if (n < 64 || n > 8192 || n % 4) return false;
  int rest = n / 2, a = 0, b = 0;
  while (rest % 2 == 0) rest /= 2, ++a;
  while (rest % 5 == 0) rest /= 5, ++b;
  const int parts = (a + 3) / 4;
  if (rest != 1 || b == 0 || parts + b > MAX_PASSES) return false;
  pl.h = n / 2;
  pl.count = parts + b;
  pl.radices = 0;
  for (int s = 0; s < pl.count; ++s) {
    const int r = s < parts ? 1 << (a / parts + (s < a % parts)) : 5;
    pl.radices |= static_cast<unsigned>(r - 1) << (4 * s);
  }
  pl.length = pl.h + 1;
  for (int s = 1, ns = radix_of(pl, 0); s < pl.count; ns *= radix_of(pl, s), ++s)
    pl.length += ns * (radix_of(pl, s) - 1);
  return true;
}

// float2 of a frame's buffer: h points, a pad after every 16
__host__ __device__ constexpr int mixed_stride(int h) { return h + h / 16 + 1; }

// Shared memory of a mixed-radix block of c frames in flight: the
// destination offsets of its RUN frames, two buffers a frame, the output
// tile, the bands' ranges and (vals > 0) the bands' entries.
size_t mixed_smem_bytes(int h, int c, int m, int vals) {
  return 8 * RUN + 16 * static_cast<size_t>(c) * mixed_stride(h) +
         4 * static_cast<size_t>(m) * RUN + 4 * (2 * static_cast<size_t>(m) + 1) +
         4 * static_cast<size_t>(vals);
}

__host__ __device__ constexpr int rev_bits(int q, int bits) {
  return bits ? ((q & 1) << (bits - 1)) | rev_bits(q >> 1, bits - 1) : 0;
}

// cos(2 pi / 5), cos(4 pi / 5), sin(2 pi / 5), sin(4 pi / 5), each rounded
// once from float64 (tests/test_torch_fft_filterbank.py holds them equal to
// the mirror's)
constexpr float C5_1 = 0x1.3c6ef4p-2f, C5_2 = -0x1.9e377ap-1f;
constexpr float S5_1 = 0x1.e6f0e2p-1f, S5_2 = 0x1.2cf23p-1f;

// 5 points -> their DFT, in natural order
__device__ __forceinline__ void dft5(float2 (&v)[5]) {
  const float2 t1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
  const float2 t2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
  const float2 t3 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
  const float2 t4 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
  const float2 a1 = make_float2(v[0].x + C5_1 * t1.x + C5_2 * t2.x,
                                v[0].y + C5_1 * t1.y + C5_2 * t2.y);
  const float2 a2 = make_float2(v[0].x + C5_2 * t1.x + C5_1 * t2.x,
                                v[0].y + C5_2 * t1.y + C5_1 * t2.y);
  const float2 b1 = make_float2(S5_1 * t3.x + S5_2 * t4.x, S5_1 * t3.y + S5_2 * t4.y);
  const float2 b2 = make_float2(S5_2 * t3.x - S5_1 * t4.x, S5_2 * t3.y - S5_1 * t4.y);
  v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);
  v[4] = make_float2(a1.x - b1.y, a1.y + b1.x);
  v[2] = make_float2(a2.x + b2.y, a2.y - b2.x);
  v[3] = make_float2(a2.x - b2.y, a2.y + b2.x);
}

// R points -> their DFT, in natural order: dft5, or the power-of-two
// kernel's dft with its outputs renamed out of bit-reversed order
template <int R>
__device__ __forceinline__ void dft_natural(float2 (&v)[R]) {
  if constexpr (R == 5) {
    dft5(v);
  } else {
    dft<R>(v);
    float2 o[R];
#pragma unroll
    for (int q = 0; q < R; ++q) o[q] = v[rev_bits(q, ilog2(R))];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = o[q];
  }
}

// The first pass, radix R: butterfly j reads points j + r h/R of the frame
// at a (zeros past the frames), windowed, and writes its DFT to points
// j R + q of z.
template <int R>
__device__ __forceinline__ void mixed_first(const float* a, bool inside, bool paired,
                                            const float* __restrict__ window, float2* z, int h,
                                            int lane) {
  const int m = h / R;
  for (int j = lane; j < m; j += 32) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + r * m;
      const float* c = a + 2 * i;
      const float2 w = __ldg(reinterpret_cast<const float2*>(window) + i);
      const float2 s = !inside ? make_float2(0.f, 0.f)
                     : paired  ? __ldg(reinterpret_cast<const float2*>(c))
                               : make_float2(__ldg(c), __ldg(c + 1));
      v[r] = make_float2(s.x * w.x, s.y * w.y);
    }
    dft_natural<R>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) z[pad16(j * R + q)] = v[q];
  }
}

// A pass after the first, radix R, with ns points already combined:
// butterfly j (k = j mod ns) reads points j + r h/R of src, turns point r by
// W_(ns R)^(r k) (the table's (r - 1) ns + k of the pass), and writes its
// DFT's output q to (j - k) R + k + q ns of dst.
template <int R>
__device__ __forceinline__ void mixed_pass(const float2* src, float2* dst, int h, int ns,
                                           const float2* __restrict__ tw, int lane) {
  const int m = h / R;
  for (int j = lane; j < m; j += 32) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad16(j + r * m)];
    const int k = j % ns;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + (r - 1) * ns + k));
    dft_natural<R>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) dst[pad16(base + q * ns)] = v[q];
  }
}

// A round's C frames, their power at pw (frame i at pw + i fstride floats),
// projected onto the bands into the tile as the power-of-two kernel's
// project does, two frames a thread.
__device__ __forceinline__ void project_mixed(const float* pw, int fstride, const int* bands,
                                              const float* fbv, float* tile, int M, int fpb,
                                              int round, int c) {
  const int groups = c / 2;
  for (int o = threadIdx.x; o < groups * M; o += blockDim.x) {
    const int m = o / groups, i0 = (o % groups) * 2;
    const float* power = pw + i0 * fstride + bands[m];
    const int e0 = bands[M + m], n = bands[M + m + 1] - e0;
    const float* fv = fbv + e0;
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    int e = 0;
    for (; e + 4 <= n; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = fv[e + u];
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[u][k] = fmaf(a, power[k * fstride + e + u], acc[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (e + u < n) {
        const float a = fv[e + u];
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[u][k] = fmaf(a, power[k * fstride + e + u], acc[u][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      tile[m * fpb + round * c + i0 + k] = (acc[0][k] + acc[1][k]) + (acc[2][k] + acc[3][k]);
  }
}

// 1,024 threads an SM: 64 registers a thread
__global__ void __launch_bounds__(32 * MIXED_WARPS, 32 / MIXED_WARPS)
framed_fft_filterbank_mixed_kernel(const float* __restrict__ x, const float* __restrict__ window,
                                   const float2* __restrict__ twiddle,
                                   const int* __restrict__ band, const float* __restrict__ vals,
                                   float* __restrict__ out, int L, int hop, int T, int M, int nnz,
                                   int frames, int rounds, float eps, MixedPasses pl) {
  const int c = blockDim.x >> 5, h = pl.h, hs = mixed_stride(h);
  const int fpb = c * rounds;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* dst = reinterpret_cast<long long*>(smem);         // RUN
  float2* buf = reinterpret_cast<float2*>(dst + RUN);          // C frames of two buffers
  float* tile = reinterpret_cast<float*>(buf + 2 * c * hs);    // M rows of RUN
  int* bands = reinterpret_cast<int*>(tile + M * RUN);         // 2M + 1
  float* svals = reinterpret_cast<float*>(bands + 2 * M + 1);  // nnz, or none

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int log2fpb = __ffs(fpb) - 1;
  float2* za = buf + 2 * warp * hs;
  float2* zb = za + hs;
  // the last pass's output and the power: za and zb, or zb and za
  const bool odd = pl.count & 1;
  const float2* fin = odd ? za : zb;
  float* pw = reinterpret_cast<float*>(odd ? zb : za);
  const float* pw0 = reinterpret_cast<const float*>(buf + (odd ? hs : 0));
  for (int i = tid; i < 2 * M + 1; i += blockDim.x) bands[i] = band[i];
  for (int i = tid; i < nnz; i += blockDim.x) svals[i] = vals[i];

  for (int g0 = blockIdx.x * fpb; g0 < frames; g0 += gridDim.x * fpb) {
    for (int round = 0; round < rounds; ++round) {
      const int g = g0 + round * c + warp, b = g / T;
      const float* a = x + static_cast<long long>(b) * L + static_cast<long long>(g - b * T) * hop;
      const bool inside = g < frames, paired = (reinterpret_cast<uintptr_t>(a) & 7) == 0;
      switch (radix_of(pl, 0)) {
        case 2: mixed_first<2>(a, inside, paired, window, za, h, lane); break;
        case 4: mixed_first<4>(a, inside, paired, window, za, h, lane); break;
        case 8: mixed_first<8>(a, inside, paired, window, za, h, lane); break;
        default: mixed_first<16>(a, inside, paired, window, za, h, lane); break;
      }
      __syncwarp();
      float2 *src = za, *to = zb;
      const float2* tw = twiddle + h + 1;  // pass s's twiddles
      for (int s = 1, ns = radix_of(pl, 0); s < pl.count; ++s) {
        const int r = radix_of(pl, s);
        switch (r) {
          case 2: mixed_pass<2>(src, to, h, ns, tw, lane); break;
          case 4: mixed_pass<4>(src, to, h, ns, tw, lane); break;
          case 8: mixed_pass<8>(src, to, h, ns, tw, lane); break;
          case 16: mixed_pass<16>(src, to, h, ns, tw, lane); break;
          default: mixed_pass<5>(src, to, h, ns, tw, lane); break;
        }
        __syncwarp();
        float2* t = src;
        src = to;
        to = t;
        tw += ns * (r - 1);
        ns *= r;
      }

      // unpack and square, as the power-of-two kernel does: for f in
      // [0, h/2], bin f is E - i W_N^f O and bin h - f is E + i W_N^f O
      for (int f = lane; f <= h / 2; f += 32) {
        const float2 p = fin[pad16(f)], q = fin[pad16(f ? h - f : 0)];
        const float er = p.x + q.x, ei = p.y - q.y;
        const float2 wo = cmul(make_float2(p.x - q.x, p.y + q.y), __ldg(twiddle + f));
        const float lr = er + wo.y, li = ei - wo.x, ur = er - wo.y, ui = ei + wo.x;
        pw[f] = (lr * lr + li * li) * 0.25f + eps;
        if (f < h / 2) pw[h - f] = (ur * ur + ui * ui) * 0.25f + eps;
      }
      __syncthreads();
      project_mixed(pw0, 4 * hs, bands, nnz ? svals : vals, tile, M, fpb, round, c);
      __syncthreads();
    }
    if (tid < fpb) {
      const int g = g0 + tid, b = g / T;
      dst[tid] = g < frames ? (static_cast<long long>(b) * M) * T + (g - b * T) : -1;
    }
    __syncthreads();
    for (int o = tid; o < fpb * M; o += blockDim.x) {
      const int i = o & (fpb - 1), m = o >> log2fpb;
      const long long d = dst[i];
      if (d >= 0) out[d + static_cast<long long>(m) * T] = tile[m * fpb + i];
    }
  }
}

// The frames in flight of a mixed-radix block (a power of two in [2, 16]),
// the most whose shared memory lets two blocks share an SM, else one; 0
// where not even two frames fit.
int mixed_warps(int h, int m, int vals) {
  for (int lim = SMEM_LIMIT / 2; lim <= SMEM_LIMIT; lim += SMEM_LIMIT / 2)
    for (int c = MIXED_WARPS; c >= 2; c /= 2)
      if (mixed_smem_bytes(h, c, m, vals) <= static_cast<size_t>(lim)) return c;
  return 0;
}

int launch_mixed(const float* x, const float* window, const float2* twiddle, const int* band,
                 const float* vals, float* out, int B, int L, int n, int hop, int T, int M,
                 int nnz, float eps, cudaStream_t stream) {
  MixedPasses pl;
  const long long frames = static_cast<long long>(B) * T;
  if (!mixed_passes(n, pl) || frames < 1 || frames > (1LL << 30) || M < 1 || nnz < 0 ||
      hop < 1 || L < n)
    return cudaErrorInvalidValue;
  // the bands' entries in shared memory where a block of 16 frames still
  // lets two blocks share an SM
  const bool vals_shared =
      mixed_smem_bytes(pl.h, MIXED_WARPS, M, nnz) <= static_cast<size_t>(SMEM_LIMIT) / 2;
  const int c = mixed_warps(pl.h, M, vals_shared ? nnz : 0);
  if (!c) return cudaErrorInvalidValue;
  const size_t bytes = mixed_smem_bytes(pl.h, c, M, vals_shared ? nnz : 0);
  static bool opened[MAX_DEVICES];
  static size_t held_bytes[MAX_DEVICES];
  static int held_warps[MAX_DEVICES], held[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !opened[dev]) {
    err = cudaFuncSetAttribute(framed_fft_filterbank_mixed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opened[dev] = true;
  }
  if (held_bytes[dev] != bytes || held_warps[dev] != c) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, framed_fft_filterbank_mixed_kernel, 32 * c, bytes);
    if (err != cudaSuccess) return err;
    held[dev] = blocks > 0 ? blocks : 1;
    held_bytes[dev] = bytes;
    held_warps[dev] = c;
  }
  // RUN frames at a time where that still gives every resident block some,
  // else c
  const long long resident = static_cast<long long>(device_sms()) * held[dev];
  const int rounds = (frames + RUN - 1) / RUN >= resident ? RUN / c : 1;
  const int fpb = c * rounds;
  const long long chunks = (frames + fpb - 1) / fpb;
  const long long grid = chunks < resident ? chunks : resident;
  framed_fft_filterbank_mixed_kernel<<<static_cast<unsigned>(grid), 32 * c, bytes, stream>>>(
      x, window, twiddle, band, vals, out, L, hop, T, M, vals_shared ? nnz : 0,
      static_cast<int>(frames), rounds, eps, pl);
  return cudaGetLastError();
}

// The twiddle table's length at a mixed-radix n, or 0 where the kernel
// cannot project its frames onto m rows.
int mixed_twiddles_if_fits(int n, int m) {
  MixedPasses pl;
  return mixed_passes(n, pl) && mixed_warps(pl.h, m, 0) ? pl.length : 0;
}

}  // namespace

// out (B, M, T) fp32 <- x (B, L) fp32 framed by n (a power of two in
// [64, 8192], or 2^a 5^b there with a >= 2: the mixed-radix kernel) at hop,
// T = (L - n) / hop + 1; window (n,), twiddle, band and vals (nnz entries)
// from ops/framed_kernels.py's FFTPlan. Returns a cudaError_t.
extern "C" int nnaudio_framed_filterbank_fft(const void* x, const void* window,
                                             const void* twiddle, const void* band,
                                             const void* vals, void* out, int B, int L,
                                             int n, int hop, int T, int M, int nnz,
                                             float eps, void* stream) {
  const float* xs = static_cast<const float*>(x);
  const float* w = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddle);
  const int* bd = static_cast<const int*>(band);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64: return launch<5>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 128: return launch<6>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 256: return launch<7>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 512: return launch<8>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 1024: return launch<9>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 2048: return launch<10>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 4096: return launch<11>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    case 8192: return launch<12>(xs, w, tw, bd, v, o, B, L, hop, T, M, nnz, eps, s);
    default: return launch_mixed(xs, w, tw, bd, v, o, B, L, n, hop, T, M, nnz, eps, s);
  }
}

namespace {

template <int LOG2H>
int twiddles_if_fits(int m) {
  return smem_bytes<LOG2H>(m, 0) <= static_cast<size_t>(SMEM_LIMIT) ? pass_offset(LOG2H, LOG2H)
                                                                     : 0;
}

}  // namespace

// The length of the twiddle table the kernel reads for frames of n samples
// (ops/framed_kernels.py, fft_twiddles, makes it), or 0 where it cannot
// project them onto m rows: n is neither a power of two in [64, 8192] nor
// 2^a 5^b there with a >= 2, or a block's shared memory would pass the
// H100's. The host asks this before it
// builds a plan, so that this file alone decides the block's shape.
extern "C" int nnaudio_framed_filterbank_fft_twiddles(int n, int m) {
  if (m < 1) return 0;
  switch (n) {
    case 64: return twiddles_if_fits<5>(m);
    case 128: return twiddles_if_fits<6>(m);
    case 256: return twiddles_if_fits<7>(m);
    case 512: return twiddles_if_fits<8>(m);
    case 1024: return twiddles_if_fits<9>(m);
    case 2048: return twiddles_if_fits<10>(m);
    case 4096: return twiddles_if_fits<11>(m);
    case 8192: return twiddles_if_fits<12>(m);
    default: return mixed_twiddles_if_fits(n, m);
  }
}

// ---------------------------------------------------------------------------
// K3's FFT route: for a frozen Fourier synthesis basis, an inverse real FFT
// of each frame, windowed and overlap-added in the same kernel.
//
// Stands beside nnaudio_tpu/ops/framed_matmul.py:
//   K3  _synthesis_ola_kernel  :878  (launched by _synthesis_ola)
// which computes OLA(kc^T Re - ks^T Im) as a dense product with the kernels,
// as the port's dense K3 (synthesis_ola.cu, synthesis_tc_kernel) does. Where
// the kernels are the Hermitian-weighted Fourier basis times w / N (their
// factors checked once, ops/framed_kernels.py build_synthesis_fft_plan),
// this kernel computes
//   y[b, t*hop + k] += w[k] / N * sum_f c_f (Re[b,f,t] cos(2 pi f k / N)
//                                          - Im[b,f,t] sin(2 pi f k / N))
// (c_f = 1 at DC and Nyquist, 2 between: an unnormalised inverse real FFT)
// for fp32 spectra (B, N/2 + 1, T) read by their own strides (unit along T
// for planar carries, 2 for the halves of a (B, F, T, 2) stack), N a power
// of two in [64, 8192] and 1 <= hop <= N, into y (B, N + hop*(T-1)).
//
// What bounds it on the H100: the spectra read once and the signal written
// once (at cell 5's B=32, T=862, N=1024, hop 256: 113.2 + 28.3 MB, 42.3 us at
// 3.35 TB/s); the inverse FFT is ~2.5 N log2 N operations a frame (0.7 GFLOP
// a call, 1.1 us at the fp32 peak). Bytes, then: the design reads each bin
// of a frame once from device memory along T, keeps the frame in shared
// memory through its FFT and the overlap-add, and writes each sample once.
//
// Design:
// - A block owns `owned` rows of hop samples of one batch item, [s0, s1),
//   and computes every frame that reaches them: owned + ceil(N/hop) - 1
//   frames, the first ceil(N/hop) - 1 of them also computed by the block
//   before (the halo); `owned` fills whole rounds of C frames where a
//   block's accumulator of SYNTH_ACC_FLOATS samples holds its rows.
// - A round stages C consecutive frames' N/2 + 1 bins into the C teams'
//   buffers, consecutive threads on consecutive frames of one bin (the
//   loads run along T), then each team of P threads takes one frame as K2's
//   route does: the onesided bins are unpacked into N/2 points
//   V[f] = E - i W_N^f D (E = conj X[f] + X[N/2-f], D = conj X[f] - X[N/2-f],
//   the imaginary parts of DC and Nyquist dropped) and the forward Stockham
//   passes of the analysis kernel run on them: FFT(V) = conj(IFFT(conj V)),
//   so the frame's samples 2j and 2j + 1 are Re and -Im of point j.
// - Samples 1 and N - 1 of a frame are summed apart, in float64: a window
//   that tapers to 0 is smallest there, and the envelope of a center=False
//   signal divides its first and last samples by that window's square
//   (w[1]^2 ~ 1.4e-9 for a Hann of 512), which would turn the FFT's rounding
//   (a fraction of an fp32 unit of the frame's largest sample, as any fp32
//   FFT's) into hundreds of units of the signal's. A thread's bins
//   f = p + r N/64 lie at the turns 2 pi p / N + r pi / 32, so while it
//   unpacks it sums Re_f and Im_f times cos(r pi / 32) and sin(r pi / 32)
//   (constants) in float64, and turns the four sums by 2 pi p / N at the end
//   (ops/framed_kernels.py's synthesis_edge, one float64 pair a thread): no
//   table read a bin. After the passes one thread of the team adds the P
//   threads' sums in order of p and writes A - B and A + B, rounded once, in
//   place of the FFT's samples 1 and N - 1.
// - Then each thread adds, for the samples it owns in [s0, s1), the round's
//   frames in order of t, each sample times w[k] / N, into the block's
//   accumulator in shared memory; the block writes it out once its frames
//   are done. Every sample is one block's, summed from zero over its frames
//   in order of t: no atomics, the same bits on every run, whatever the
//   block's rows.
// ops/framed_kernels.py's synthesis_ola_fft_plain repeats this arithmetic
// in PyTorch.

namespace {

// cos(t pi / 32) for t in [0, 16] in float64, each rounded once
__device__ __forceinline__ constexpr double cos_pi32(int t) {
  return t == 0 ? 1.0
       : t == 1 ? 0x1.fd88da3d12526p-1
       : t == 2 ? 0x1.f6297cff75cb0p-1
       : t == 3 ? 0x1.e9f4156c62ddap-1
       : t == 4 ? 0x1.d906bcf328d46p-1
       : t == 5 ? 0x1.c38b2f180bdb1p-1
       : t == 6 ? 0x1.a9b66290ea1a3p-1
       : t == 7 ? 0x1.8bc806b151741p-1
       : t == 8 ? 0x1.6a09e667f3bcdp-1
       : t == 9 ? 0x1.44cf325091dd6p-1
       : t == 10 ? 0x1.1c73b39ae68c9p-1
       : t == 11 ? 0x1.e2b5d3806f63ep-2
       : t == 12 ? 0x1.87de2a6aea964p-2
       : t == 13 ? 0x1.294062ed59f05p-2
       : t == 14 ? 0x1.8f8b83c69a60dp-3
       : t == 15 ? 0x1.917a6bc29b438p-4
       : 0.0;
}

constexpr int SYNTH_ACC_FLOATS = 8192;  // samples of a block's accumulator, at most
constexpr int STAGE = 8;                // bins a thread loads before it stores them

// Shared memory of a synthesis block: the threads' two float64 sums of the
// edge samples, the C frames' buffers, then the accumulator of `acc` samples.
template <int LOG2H>
constexpr size_t synth_smem_bytes(int acc) {
  using S = Shape<LOG2H>;
  return 16 * static_cast<size_t>(S::THREADS) + 8 * static_cast<size_t>(S::C) * S::STRIDE +
         4 * static_cast<size_t>(acc);
}

// grid: one block per `owned` rows of hop samples of one batch item
template <int LOG2H>
__global__ void __launch_bounds__(Shape<LOG2H>::THREADS, MIN_BLOCKS)
synthesis_fft_ola_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                         long long sb, long long sf, long long st,
                         const float* __restrict__ scale, const float2* __restrict__ twiddle,
                         const double2* __restrict__ edge_w, float* __restrict__ y, int T,
                         int hop, int length, int owned, int chunks) {
  using S = Shape<LOG2H>;
  constexpr int MP = S::H / RADIX;  // the first pass's stride, in points
  extern __shared__ __align__(16) unsigned char smem[];
  double2* edge = reinterpret_cast<double2*>(smem);                // a thread's (A, B)
  float2* buf = reinterpret_cast<float2*>(edge + S::THREADS);      // C frames of STRIDE
  float* acc = reinterpret_cast<float*>(buf + S::C * S::STRIDE);  // owned * hop samples

  const int tid = threadIdx.x;
  const int team = tid / S::P, p = tid % S::P;
  float2* z = buf + team * S::STRIDE;
  const int b = blockIdx.x / chunks, chunk = blockIdx.x - b * chunks;
  const int r0 = chunk * owned, s0 = r0 * hop;
  const int s1 = min(s0 + owned * hop, length);
  // the frames that reach [s0, s1): t*hop + N > s0 and t*hop < s1
  const int tf0 = max(0, r0 - (S::N + hop - 1) / hop + 1);
  const int tf1 = min(T, r0 + owned);
  const float* re = sre + static_cast<long long>(b) * sb;
  const float* im = sim + static_cast<long long>(b) * sb;
  for (int i = tid; i < s1 - s0; i += S::THREADS) acc[i] = 0.f;

  for (int ta = tf0; ta < tf1; ta += S::C) {
    const int frames = min(S::C, tf1 - ta);
    // the round's bins, frame i of the round into team i's buffer: STAGE
    // loads of each plane in flight a thread before their stores
    constexpr int ITEMS = (S::H + 1) * S::C;
    for (int e0 = tid; e0 < ITEMS; e0 += STAGE * S::THREADS) {
      float2 got[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * S::THREADS, i = e & (S::C - 1), f = e >> S::LOG2C;
        const long long at = f * sf + (ta + i) * st;
        got[u] = e < ITEMS && i < frames ? make_float2(__ldg(re + at), __ldg(im + at))
                                         : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * S::THREADS;
        if (e < ITEMS) buf[(e & (S::C - 1)) * S::STRIDE + pad16(e >> S::LOG2C)] = got[u];
      }
    }
    __syncthreads();

    // every team runs (a team past the round's frames on what its buffer
    // holds, unread), since teams of fewer than 32 threads share a warp's
    // barrier: the unpacking into the first pass, its DFT, placed, then the
    // passes after it
    float2 v[RADIX];
    // the edge samples' sums over this thread's bins: Re and Im times
    // cos(r pi / 32) and sin(r pi / 32)
    double rc = 0.0, rs = 0.0, ic = 0.0, is = 0.0;
#pragma unroll
    for (int r = 0; r < RADIX; ++r) {
      const int f = p + r * MP;
      float2 a = z[pad16(f)], c = z[pad16(S::H - f)];
      if (r == 0 && p == 0) a.y = c.y = 0.f;  // DC and Nyquist are real
      const double cr = r <= 16 ? cos_pi32(r) : -cos_pi32(32 - r);
      const double sr = r <= 16 ? cos_pi32(16 - r) : cos_pi32(r - 16);
      const double re = a.x, im = a.y;
      rc = fma(re, cr, rc);
      rs = fma(re, sr, rs);
      ic = fma(im, cr, ic);
      is = fma(im, sr, is);
      const float2 wd = cmul(make_float2(a.x - c.x, -a.y - c.y), __ldg(twiddle + f));
      v[r] = make_float2(a.x + c.x + wd.y, c.y - a.y - wd.x);
    }
    {  // turned by 2 pi p / N, weighted 2 (c_f), less DC once and Nyquist (cos(pi) = -1)
      const double2 e = __ldg(edge_w + p);
      double ea = 2.0 * (e.x * rc - e.y * rs);
      if (p == 0) ea -= static_cast<double>(z[0].x) + z[pad16(S::H)].x;
      edge[tid] = make_double2(ea, 2.0 * (e.y * ic + e.x * is));
    }
    dft<RADIX>(v);
    team_sync<S::P, S::THREADS>(team);
    put<ilog2(RADIX), 0>(z, p, v);
    team_sync<S::P, S::THREADS>(team);
    fft_passes<LOG2H, ilog2(RADIX)>(z, p, team, twiddle);
    if (p == 0) {  // A - B and A + B for samples 1 and N - 1, stored as -Im
      double sa = 0.0, sb = 0.0;
      for (int q = 0; q < S::P; ++q) {
        sa += edge[tid + q].x;
        sb += edge[tid + q].y;
      }
      float* fz = reinterpret_cast<float*>(z);
      fz[1] = -static_cast<float>(sa - sb);
      fz[2 * pad16(S::H - 1) + 1] = -static_cast<float>(sa + sb);
    }
    __syncthreads();

    // the round's frames into the samples this thread owns, in order of t
    for (int i = 0; i < frames; ++i) {
      const int base = (ta + i) * hop;
      const float* fz = reinterpret_cast<const float*>(buf + i * S::STRIDE);
      const int lo = max(s0, base), hi = min(s1, base + S::N);
      const int first = s0 + tid;
      int s = lo <= first ? first : first + (lo - first + S::THREADS - 1) / S::THREADS * S::THREADS;
      for (; s < hi; s += S::THREADS) {
        const int k = s - base;
        const float u = fz[2 * pad16(k >> 1) + (k & 1)];
        acc[s - s0] += (k & 1 ? -u : u) * __ldg(scale + k);
      }
    }
    __syncthreads();
  }
  float* out = y + static_cast<long long>(b) * length;
  for (int i = tid; i < s1 - s0; i += S::THREADS) out[s0 + i] = acc[i];
}

template <int LOG2H>
int launch_synthesis(const float* sre, const float* sim, long long sb, long long sf,
                     long long st, const float* scale, const float2* twiddle,
                     const double2* edge, float* y, int B, int T, int hop,
                     cudaStream_t stream) {
  using S = Shape<LOG2H>;
  if (B < 1 || T < 1 || hop < 1 || hop > S::N) return cudaErrorInvalidValue;
  const long long length = S::N + static_cast<long long>(hop) * (T - 1);
  if (length > (1LL << 31) - 1) return cudaErrorInvalidValue;
  // rows a block owns: its frames, owned + nch - 1, in whole rounds of C
  // where the accumulator holds the rows (else as many rows as it holds),
  // at most the signal's; fewer by whole rounds where that leaves blocks
  // for every SM and a round's frames still outnumber the halo
  const int nch = (S::N + hop - 1) / hop;
  const int fit = SYNTH_ACC_FLOATS / hop;
  const int rows = static_cast<int>((length + hop - 1) / hop);
  int owned = (fit + nch - 1) / S::C * S::C - (nch - 1);
  if (owned < 1) owned = fit;
  if (owned > rows) owned = rows;
  const long long resident = 2LL * device_sms();
  while (owned - S::C >= nch - 1 && owned > S::C &&
         static_cast<long long>(B) * ((rows + owned - 1) / owned) < resident)
    owned -= S::C;
  const int chunks = (rows + owned - 1) / owned;
  const long long grid = static_cast<long long>(B) * chunks;
  if (grid > (1LL << 31) - 1) return cudaErrorInvalidValue;
  const size_t bytes = synth_smem_bytes<LOG2H>(owned * hop);
  static bool opened[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !opened[dev]) {
    err = cudaFuncSetAttribute(synthesis_fft_ola_kernel<LOG2H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opened[dev] = true;
  }
  synthesis_fft_ola_kernel<LOG2H><<<static_cast<unsigned>(grid), S::THREADS, bytes, stream>>>(
      sre, sim, sb, sf, st, scale, twiddle, edge, y, T, hop, static_cast<int>(length), owned,
      chunks);
  return cudaGetLastError();
}

}  // namespace

// y (B, n + hop*(T-1)) fp32 <- the spectra sre, sim (B, n/2 + 1, T) fp32 at
// strides (sb, sf, st) elements, n a power of two in [64, 8192], 1 <= hop <=
// n; scale (n,) the window over n, twiddle and edge (n/64 float64 pairs)
// from ops/framed_kernels.py's SynthesisFFTPlan. Returns a cudaError_t.
extern "C" int nnaudio_synthesis_fft(const void* sre, const void* sim, long long sb,
                                     long long sf, long long st, const void* scale,
                                     const void* twiddle, const void* edge, void* y, int B,
                                     int T, int n, int hop, void* stream) {
  const float* re = static_cast<const float*>(sre);
  const float* im = static_cast<const float*>(sim);
  const float* sc = static_cast<const float*>(scale);
  const float2* tw = static_cast<const float2*>(twiddle);
  const double2* ed = static_cast<const double2*>(edge);
  float* o = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64: return launch_synthesis<5>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 128: return launch_synthesis<6>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 256: return launch_synthesis<7>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 512: return launch_synthesis<8>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 1024: return launch_synthesis<9>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 2048: return launch_synthesis<10>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 4096: return launch_synthesis<11>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    case 8192: return launch_synthesis<12>(re, im, sb, sf, st, sc, tw, ed, o, B, T, hop, s);
    default: return cudaErrorInvalidValue;
  }
}

// The length of the twiddle table the synthesis kernel reads for frames of
// n samples, or 0 where n is not a power of two in [64, 8192].
extern "C" int nnaudio_synthesis_fft_twiddles(int n) {
  switch (n) {
    case 64: return pass_offset(5, 5);
    case 128: return pass_offset(6, 6);
    case 256: return pass_offset(7, 7);
    case 512: return pass_offset(8, 8);
    case 1024: return pass_offset(9, 9);
    case 2048: return pass_offset(10, 10);
    case 4096: return pass_offset(11, 11);
    case 8192: return pass_offset(12, 12);
    default: return 0;
  }
}

// ---------------------------------------------------------------------------
// K4's FFT route: one Griffin-Lim analysis step for a frozen Fourier basis,
// the real FFT of each frame and the loop's carry update in one pass.
//
// Stands beside nnaudio_tpu/ops/framed_matmul.py:
//   K4  _gl_step_kernel  :239  (launched by _framed_gl_step)
// which computes the pair as a dense product with the bases, then the
// update, as the port's dense K4 (framed_tc.cu GL_STEP) does; where the
// pair is the windowed DFT of its window w = wcos[0] (ops/framed_kernels.py,
// build_gl_step_fft_plan), this kernel computes, for fp32 storage and fp32
// carries and N a power of two in [64, 8192],
//   r[b,f,t] = rfft(w * x[b, t*hop : t*hop + N])[f]      (r = (re, -im_raw))
//   n = r - mom p,  c = S n rsqrt(|n|^2 + 1e-32)
// and writes c_re, c_im, r_re, r_im, each planar (B, N/2 + 1, T): the
// update's arithmetic and constant are ops/framed_kernels.py gl_update's.
//
// What bounds it on the H100: at cell 5's shape (B=32, T=862, N=1024, hop
// 256) the padded signal in (28.3 MB), S, p_re and p_im in and the four
// carries out (56.6 MB a plane) are 424.6 MB, 0.127 ms at 3.35 TB/s; the
// arithmetic, a real FFT a frame and 12 operations a bin, is 0.88 GFLOP,
// 13 us on the CUDA cores. Bytes, then: the design moves each plane once,
// along T, with the frames' FFTs kept in shared memory between the two.
//
// Design:
// - A block of GL_THREADS threads takes C consecutive frames of the
//   flattened (b, t) index at a time (a run: 32 frames for N <= 1024), one
//   frame to a team of P = N/64 threads, every gridDim.x runs. Each team
//   reads its frame from device memory, windowed on the way (K2's loader: a
//   run's frames overlap by N - hop, which the cache serves), runs K2's
//   Stockham passes on its buffer, and unpacks the real FFT's bins f and
//   N/2 - f from the complex points f and N/2 - f in place, halved: bin f
//   at the buffer's point f. At N >= 1024 the buffers of a run take 139.5
//   KB, so an SM holds one block.
// - The update takes the run's bins by rows: element e of the block is bin
//   e / C of frame e % C, so each warp reads S, p_re and p_im and writes c
//   and r in runs of C consecutive frames of a row, 128 bytes at C = 32
//   (the carries stay planar (B, F, T), as K3's route and the NNLS read
//   them); a thread reads GL_U elements' operands before it computes any.
//   The update's operations are rounded one at a time, in gl_update's
//   order (no contraction into fused multiply-adds), rsqrtf as ATen's
//   rsqrt. The update moves 93% of the bytes and takes most of the time:
//   timed on an H100 at cell 5's step, a build without it takes 0.055 ms
//   of the kernel's ~0.245 ms; runs of 16 frames (256 threads, two blocks
//   an SM), more elements in flight a thread (4 or 8) and reading the next
//   run's frames during the update were each slower.
// - Fixed order, no atomics: every run gives the same bits, whatever the
//   grid.
// ops/framed_kernels.py's gl_step_fft_plain repeats this arithmetic in
// PyTorch.

namespace {

constexpr int GL_THREADS = 512;  // threads of a block, at most
constexpr int GL_U = 2;          // elements a thread reads before it updates them

template <int LOG2H>
struct GLShape {
  static constexpr int H = Shape<LOG2H>::H, P = Shape<LOG2H>::P;
  static constexpr int STRIDE = Shape<LOG2H>::STRIDE;
  static constexpr int C = GL_THREADS / P < MAX_TEAMS ? GL_THREADS / P : MAX_TEAMS;  // a run
  static constexpr int THREADS = P * C;
  static constexpr int LOG2C = ilog2(C);
  static constexpr int F = H + 1;  // bins of a frame
};

// Shared memory of a step block: the run's C frames' offsets into (B, F, T),
// then their buffers.
template <int LOG2H>
constexpr size_t gl_smem_bytes() {
  using G = GLShape<LOG2H>;
  return 8 * static_cast<size_t>(G::C) + 8 * static_cast<size_t>(G::C) * G::STRIDE;
}

template <int LOG2H>
__global__ void __launch_bounds__(GLShape<LOG2H>::THREADS, 1)
gl_step_fft_kernel(const float* __restrict__ x, const float* __restrict__ window,
                   const float2* __restrict__ twiddle, const float* __restrict__ mag,
                   const float* __restrict__ p_re, const float* __restrict__ p_im,
                   float* __restrict__ c_re, float* __restrict__ c_im,
                   float* __restrict__ r_re, float* __restrict__ r_im, int L, int hop, int T,
                   int frames, float mom) {
  using S = Shape<LOG2H>;
  using G = GLShape<LOG2H>;
  constexpr int MP = S::H / RADIX;  // the first pass's stride, in points
  extern __shared__ __align__(16) unsigned char smem[];
  long long* base = reinterpret_cast<long long*>(smem);     // C: b F T + t, or -1
  float2* buf = reinterpret_cast<float2*>(base + G::C);     // C frames of STRIDE

  const int tid = threadIdx.x;
  const int team = tid / S::P, p = tid % S::P;
  float2* z = buf + team * S::STRIDE;
  float2 v[RADIX];

  for (int g0 = blockIdx.x * G::C; g0 < frames; g0 += gridDim.x * G::C) {
    // the first pass, from the team's frame as read: windowed, its DFT,
    // placed; then the passes after it
    fetch<LOG2H>(v, x, g0 + team, frames, T, L, hop, p);
#pragma unroll
    for (int r = 0; r < RADIX; ++r) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(window) + p + r * MP);
      v[r] = make_float2(v[r].x * w.x, v[r].y * w.y);
    }
    dft<RADIX>(v);
    put<ilog2(RADIX), 0>(z, p, v);
    team_sync<S::P, S::THREADS>(team);
    fft_passes<LOG2H, ilog2(RADIX)>(z, p, team, twiddle);

    // unpack in place, halved: for f = p + q P in [0, N/4], bin f is
    // (E - i W_N^f O) / 2 and bin N/2 - f is conj(E + i W_N^f O) / 2, each
    // at its own point (Nyquist at point N/2, past the FFT's; bin N/4 once,
    // by thread 0). A thread reads and writes only its own pairs' points.
    constexpr int PAIRS = RADIX / 2 + 1;
    const int pp = pad16(p);
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int f = p + q * S::P;
      if (q < PAIRS - 1 || p == 0) {
        const int at = pad16_add<S::P>(p, pp, q);
        const float2 a = z[at], c = z[pad16((S::H - f) & (S::H - 1))];
        const float er = a.x + c.x, ei = a.y - c.y;
        const float2 wo = cmul(make_float2(a.x - c.x, a.y + c.y), __ldg(twiddle + f));
        z[at] = make_float2(0.5f * (er + wo.y), 0.5f * (ei - wo.x));
        if (q < PAIRS - 1) z[pad16(S::H - f)] = make_float2(0.5f * (er - wo.y), -0.5f * (ei + wo.x));
      }
    }
    if (tid < G::C) {
      const int g = g0 + tid, b = g / T;
      base[tid] = g < frames ? static_cast<long long>(b) * G::F * T + (g - b * T) : -1;
    }
    __syncthreads();

    // the update, by rows of the run's frames
    for (int e0 = tid; e0 < G::F * G::C; e0 += GL_U * G::THREADS) {
      long long at[GL_U];
      float s[GL_U], pr[GL_U], pi[GL_U];
#pragma unroll
      for (int u = 0; u < GL_U; ++u) {
        const int e = e0 + u * G::THREADS;
        const long long d = e < G::F * G::C ? base[e & (G::C - 1)] : -1;
        at[u] = d < 0 ? -1 : d + static_cast<long long>(e >> G::LOG2C) * T;
        s[u] = at[u] < 0 ? 0.f : __ldg(mag + at[u]);
        pr[u] = at[u] < 0 ? 0.f : __ldg(p_re + at[u]);
        pi[u] = at[u] < 0 ? 0.f : __ldg(p_im + at[u]);
      }
#pragma unroll
      for (int u = 0; u < GL_U; ++u) {
        if (at[u] < 0) continue;
        const int e = e0 + u * G::THREADS;
        const float2 r = buf[(e & (G::C - 1)) * S::STRIDE + pad16(e >> G::LOG2C)];
        const float nr = __fsub_rn(r.x, __fmul_rn(mom, pr[u]));
        const float ni = __fsub_rn(r.y, __fmul_rn(mom, pi[u]));
        const float sq = __fadd_rn(__fadd_rn(__fmul_rn(nr, nr), __fmul_rn(ni, ni)), 1e-32f);
        const float scale = __fmul_rn(s[u], rsqrtf(sq));
        c_re[at[u]] = __fmul_rn(nr, scale);
        c_im[at[u]] = __fmul_rn(ni, scale);
        r_re[at[u]] = r.x;
        r_im[at[u]] = r.y;
      }
    }
    __syncthreads();
  }
}

template <int LOG2H>
int launch_gl_step(const float* x, const float* window, const float2* twiddle, const float* mag,
                   const float* p_re, const float* p_im, float* c_re, float* c_im, float* r_re,
                   float* r_im, int B, int L, int hop, int T, float mom, cudaStream_t stream) {
  using G = GLShape<LOG2H>;
  const long long frames = static_cast<long long>(B) * T;
  if (frames < 1 || frames > (1LL << 30) || hop < 1 || L < Shape<LOG2H>::N ||
      static_cast<long long>(hop) * (T - 1) + Shape<LOG2H>::N > L)
    return cudaErrorInvalidValue;
  const size_t bytes = gl_smem_bytes<LOG2H>();
  static bool opened[MAX_DEVICES];
  static int held[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opened[dev]) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(gl_step_fft_kernel<LOG2H>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (err != cudaSuccess) return err;
    }
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gl_step_fft_kernel<LOG2H>,
                                                        G::THREADS, bytes);
    if (err != cudaSuccess) return err;
    held[dev] = n > 0 ? n : 1;
    opened[dev] = true;
  }
  const long long resident = static_cast<long long>(device_sms()) * held[dev];
  const long long runs = (frames + G::C - 1) / G::C;
  const long long grid = runs < resident ? runs : resident;
  gl_step_fft_kernel<LOG2H><<<static_cast<unsigned>(grid), G::THREADS, bytes, stream>>>(
      x, window, twiddle, mag, p_re, p_im, c_re, c_im, r_re, r_im, L, hop, T,
      static_cast<int>(frames), mom);
  return cudaGetLastError();
}

template <int LOG2H>
int gl_twiddles_if_fits() {
  return gl_smem_bytes<LOG2H>() <= static_cast<size_t>(SMEM_LIMIT) ? pass_offset(LOG2H, LOG2H)
                                                                   : 0;
}

}  // namespace

// c_re, c_im, r_re, r_im (B, n/2 + 1, T) fp32 <- x (B, L) fp32 framed by n
// (a power of two in [64, 8192]) at hop, T = (L - n) / hop + 1, with S,
// p_re, p_im (B, n/2 + 1, T) fp32 and mom; window (n,) and twiddle from
// ops/framed_kernels.py's GLStepFFTPlan. Returns a cudaError_t.
extern "C" int nnaudio_gl_step_fft(const void* x, const void* window, const void* twiddle,
                                   const void* mag, const void* p_re, const void* p_im,
                                   void* c_re, void* c_im, void* r_re, void* r_im, int B, int L,
                                   int n, int hop, int T, float mom, void* stream) {
  const float* xs = static_cast<const float*>(x);
  const float* w = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddle);
  const float* s = static_cast<const float*>(mag);
  const float* pr = static_cast<const float*>(p_re);
  const float* pi = static_cast<const float*>(p_im);
  float* cr = static_cast<float*>(c_re);
  float* ci = static_cast<float*>(c_im);
  float* rr = static_cast<float*>(r_re);
  float* ri = static_cast<float*>(r_im);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NNAUDIO_GL_STEP(LOG2H) \
  launch_gl_step<LOG2H>(xs, w, tw, s, pr, pi, cr, ci, rr, ri, B, L, hop, T, mom, st)
  switch (n) {
    case 64: return NNAUDIO_GL_STEP(5);
    case 128: return NNAUDIO_GL_STEP(6);
    case 256: return NNAUDIO_GL_STEP(7);
    case 512: return NNAUDIO_GL_STEP(8);
    case 1024: return NNAUDIO_GL_STEP(9);
    case 2048: return NNAUDIO_GL_STEP(10);
    case 4096: return NNAUDIO_GL_STEP(11);
    case 8192: return NNAUDIO_GL_STEP(12);
    default: return cudaErrorInvalidValue;
  }
#undef NNAUDIO_GL_STEP
}

// The length of the twiddle table the step kernel reads for frames of n
// samples, or 0 where it cannot run them: n is not a power of two in
// [64, 8192], or a block's shared memory would pass the H100's.
extern "C" int nnaudio_gl_step_fft_twiddles(int n) {
  switch (n) {
    case 64: return gl_twiddles_if_fits<5>();
    case 128: return gl_twiddles_if_fits<6>();
    case 256: return gl_twiddles_if_fits<7>();
    case 512: return gl_twiddles_if_fits<8>();
    case 1024: return gl_twiddles_if_fits<9>();
    case 2048: return gl_twiddles_if_fits<10>();
    case 4096: return gl_twiddles_if_fits<11>();
    case 8192: return gl_twiddles_if_fits<12>();
    default: return 0;
  }
}
