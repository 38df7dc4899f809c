// Split-K framed magnitude / power on Hopper's tensor cores (sm_90a), each
// bin group's contraction bounded by its wavelets: the giant-bank kernel (K6).
//
// Replaces nnaudio_tpu/ops/framed_matmul.py _magnitude_kchunk_kernel (:482),
// launched by _framed_magnitude_kchunk (:597, pallas_call :626) and planned
// by _plan_kchunk (:553). It computes the same function as K1 (framed_tc.cu,
// MAGNITUDE / POWER),
//   re[b,f,t] = sum_k x[b, t*hop + k] * wcos[f,k]      (im with wsin)
//   out[b,f,t] = sqrt(re^2 + im^2 + eps), or the power itself when `square`,
// for a bank of few bins (F <= 128) and a long contraction: CQT1992v2's 84
// wavelets of 16384 samples, hop 512.
//
// Bounds at that shape, B=32, T=431, on the H100 SXM at 700 W (495 TFLOP/s
// TF32, 989 bf16, 3.35 TB/s):
// - dense, 4*B*T*F*N = 75.9 GFLOP: 0.153 ms in TF32, 0.077 ms in bf16;
// - structural, the products against the bank's nonzero entries only,
//   4*B*T*nnz with nnz = 200,421 of 84 x 16384 (each wavelet is centred in
//   its row and the row is zero elsewhere): 11.1 GFLOP, 0.022 ms in TF32,
//   0.011 ms in bf16. Signal, banks and output are ~46 MB in fp32 (0.014
//   ms), so the operations bound it. For a dense bank (CQT1992's composed
//   basis, a trained bank) the two counts are one.
// The FMA kernel this replaces ran on the CUDA cores (67 TFLOP/s fp32) and
// multiplied every zero: 85% of its products at that shape.
//
// Design:
// - A pre-pass (kchunk_pack_kernel, one block per bin row) reads the banks
//   once per call and writes into the wrapper's workspace the row's range
//   [first, last + 1) of columns where cos or sin is nonzero, and the bank
//   packed for the tensor cores: per group of GROUP bins and 128-byte K
//   chunk one contiguous tile of GROUP cos rows then GROUP sin rows, already
//   in the 128-byte swizzle the products read, zeros past N; in fp32 as TF32
//   hi and lo planes (a = hi + lo), since `wgmma` cannot split an operand
//   that it reads from shared memory. Nothing is cached and nothing returns
//   to the host: a bank edited in place is seen on the next call.
// - The main kernel (kchunk_tc_kernel): a block owns 128 frames of one batch
//   item, every bin and one split of K. Frames are the M side: each of two
//   multiplying warpgroups takes 64 frames as A, read from the frame tile by
//   `ldmatrix` into registers (and split into hi and lo there in fp32). A
//   bin group is the N side: its 2 * GROUP packed rows are the B tile, so one
//   `wgmma` m64n(2*GROUP) gives the group's re and im together. A block
//   takes the hull of each group's row ranges (group_hulls) and issues a
//   group's products for a K chunk only when the chunk meets the group's
//   range, rounded out to whole chunks, a test every thread makes alike. A
//   chunk that meets no group is not loaded.
// - The work is uneven along K: with centred wavelets the middle chunks carry
//   every group and the outer ones group 0 alone. A split is therefore an
//   equal share of the work (the active group-chunks): each block finds its
//   [first, last) chunk on the device by a binary search over the prefix
//   count of active groups. The wrapper plans only the split count, from
//   the shapes.
// - One loading warpgroup copies the frame tile (any hop, N, L and pointer
//   alignment: `cp.async` pieces of 16, 8 or 4 bytes, or 2-byte loads
//   through registers for bf16 at odd addresses; zeros for t >= T and
//   k >= N) and the active groups' packed tiles (one bulk copy by the copy
//   engine per tile and plane, counted in bytes on the stage's barrier) into
//   a ring of stages in the 128-byte swizzle, handed over by `mbarrier`s as
//   in framed_tc.cu.
// - Precision by storage type, as framed_tc.cu does it. fp32 storage
//   (highest, tensorfloat32) takes 3xTF32: per group and 32-sample chunk the
//   tensor cores sum lo*hi, hi*lo and hi*hi from zero and the CUDA cores add
//   that to the running sum (`wgmma` truncates its fp32 sum). bf16 storage
//   (default) takes one bf16 product per group, summed in `wgmma`.
// - Split-K with a deterministic second pass: with more than one split each
//   block stores its partial re and im in the workspace and
//   kchunk_reduce_kernel sums the splits in index order and applies the
//   epilogue. No atomics: a second launch gives the same bits.
//
// A deliberate difference from the plain version, K1 and the JAX package: a
// signal sample that meets only bank columns outside every group's range
// (rounded out to whole K chunks) is never multiplied, so an inf or NaN
// there does not reach the output. No sample is checked for finiteness.
//
// Storage type S is float or bf16; every product accumulates in fp32. The
// launchers return cudaError_t.

#include <climits>

#include "tc_common.cuh"

namespace {

// bins per group: a product is m64n(2*GROUP). 32 against 16 and 8 on the
// H100 (tools/kchunk_ab.py): the wider products cost less per column than
// the narrower bands save at (g), and win on dense banks
constexpr int GROUP = 32;
constexpr int BT = 128;               // frames per block, 64 per multiplying warpgroup
constexpr int LOADERS = 128;          // threads of the loading warpgroup
constexpr int NT = 256 + LOADERS;     // two multiplying warpgroups, then the loading one
constexpr int MULTIPLIER_REGS = 232;  // 256 * 232 + 128 * 40 <= 65,536
constexpr int LOADER_REGS = 40;
constexpr int MAX_F = 128;
constexpr int HEADER_BYTES = 2048;    // row ranges (2 * MAX_F ints), then the group ranges
constexpr int GROUP_RANGES = 1024;    // byte offset of the group ranges in the header
constexpr int PACK_THREADS = 512;
constexpr int PACK_UNROLL = 8;        // loads in flight per pre-pass thread
constexpr int RING_BYTES = 200 * 1024;
constexpr int FRAME_BYTES = BT * ROW_BYTES;  // 16 KB
constexpr int TILE_BYTES_G = 2 * GROUP * ROW_BYTES;  // one group's tile of one plane

// K chunk: one 128-byte row of samples
template <typename S> struct Kc;
template <> struct Kc<float> { static constexpr int PLANES = 2, BK = 32; };
template <> struct Kc<__nv_bfloat16> { static constexpr int PLANES = 1, BK = 64; };

// A stage holds the frame tile, then per plane CAP / GROUP group tiles of
// 2 * GROUP rows (cos, then sin), each at its group's place.
template <typename S, int CAP> struct Ring {
  static constexpr int PLANE_BYTES = 2 * CAP * ROW_BYTES;
  static constexpr int STAGE_BYTES = FRAME_BYTES + Kc<S>::PLANES * PLANE_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 4 ? RING_BYTES / STAGE_BYTES : 4;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

// The workspace: the header of ranges, the packed bank, and with more than
// one split the partial re and im, each (splits, B, F, T) fp32.
struct Layout {
  int cap, bk, npad;
  long long packed_off, partial_off, bytes;
};

Layout layout(int B, int F, int N, int T, int splits, int bf16) {
  Layout l;
  l.cap = (F + 31) / 32 * 32;
  l.bk = bf16 ? 64 : 32;
  l.npad = (N + l.bk - 1) / l.bk * l.bk;
  const long long packed =
      static_cast<long long>(bf16 ? 1 : 2) * 2 * l.cap * l.npad * (bf16 ? 2 : 4);
  l.packed_off = HEADER_BYTES;
  l.partial_off = l.packed_off + (packed + 255) / 256 * 256;
  l.bytes = l.partial_off +
            (splits > 1 ? 2LL * splits * B * F * static_cast<long long>(T) * 4 : 0);
  return l;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename S> __device__ __forceinline__ S zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// one bank value into the packed planes: fp32 as TF32 hi and lo
__device__ __forceinline__ void pack_store(float* p, long long plane, long long at, float v) {
  const uint32_t hi = tf32_rna(v);
  p[at] = __uint_as_float(hi);
  p[plane + at] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
}
__device__ __forceinline__ void pack_store(__nv_bfloat16* p, long long, long long at,
                                           __nv_bfloat16 v) {
  p[at] = v;
}

// ------------------------------------------------------------- pre-pass --
// Block f: bin f's cos and sin rows into the packed planes (zeros past N and
// for f >= F), and its range rows[2f], rows[2f + 1] = [first, last + 1) of
// the columns where either is nonzero, (N, 0) when none is. A NaN counts as
// nonzero. A plane holds per group g and chunk c one tile of 2 * GROUP rows
// of BK samples, row r's 16-byte piece j at j ^ (r % 8).
template <typename S>
__global__ void __launch_bounds__(PACK_THREADS) kchunk_pack_kernel(
    const S* __restrict__ wcos, const S* __restrict__ wsin, S* __restrict__ packed,
    int* __restrict__ rows, int F, int N, int npad, int cap) {
  constexpr int BK = Kc<S>::BK, EPC = 16 / static_cast<int>(sizeof(S));
  const int f = blockIdx.x;
  const long long plane = 2LL * cap * npad;
  const long long group_base = static_cast<long long>(f / GROUP) * npad * 2 * GROUP;
  const int r_cos = f % GROUP, r_sin = GROUP + f % GROUP;
  // where sample k of packed row r lies in its plane
  auto at = [group_base](int r, int k) {
    const int c = k / BK, j = k % BK;
    return group_base + (static_cast<long long>(c) * 2 * GROUP + r) * BK +
           ((j / EPC) ^ (r & 7)) * EPC + j % EPC;
  };
  const S* wc = wcos + static_cast<long long>(f) * N;
  const S* ws = wsin + static_cast<long long>(f) * N;
  int lo = INT_MAX, hi = 0;
  for (int k0 = threadIdx.x; k0 < npad; k0 += PACK_THREADS * PACK_UNROLL) {
    S c[PACK_UNROLL], s[PACK_UNROLL];
#pragma unroll
    for (int u = 0; u < PACK_UNROLL; ++u) {
      const int k = k0 + u * PACK_THREADS;
      const bool ok = f < F && k < N;
      c[u] = ok ? wc[k] : zero_of<S>();
      s[u] = ok ? ws[k] : zero_of<S>();
    }
#pragma unroll
    for (int u = 0; u < PACK_UNROLL; ++u) {
      const int k = k0 + u * PACK_THREADS;
      if (k >= npad) continue;
      if (to_f(c[u]) != 0.f || to_f(s[u]) != 0.f) {
        lo = min(lo, k);
        hi = max(hi, k + 1);
      }
      pack_store(packed, plane, at(r_cos, k), c[u]);
      pack_store(packed, plane, at(r_sin, k), s[u]);
    }
  }
  __shared__ int red[2][PACK_THREADS / 32];
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = lo;
    red[1][threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < PACK_THREADS / 32; ++w) {
      lo = min(lo, red[0][w]);
      hi = max(hi, red[1][w]);
    }
    rows[2 * f] = lo < hi ? lo : N;
    rows[2 * f + 1] = lo < hi ? hi : 0;
  }
}

// [k_lo, k_hi) of each group g < ngroups: the hull of its rows' ranges,
// (0, 0) where every row of the group is zero
__device__ __forceinline__ void group_hulls(const int* __restrict__ rows, int F,
                                            int ngroups, int* out, int tid,
                                            int nthreads) {
  for (int g = tid; g < ngroups; g += nthreads) {
    int lo = INT_MAX, hi = 0;
    for (int r = 0; r < GROUP && g * GROUP + r < F; ++r) {
      lo = min(lo, rows[2 * (g * GROUP + r)]);
      hi = max(hi, rows[2 * (g * GROUP + r) + 1]);
    }
    out[2 * g] = lo < hi ? lo : 0;
    out[2 * g + 1] = lo < hi ? hi : 0;
  }
}

__global__ void kchunk_hull_kernel(const int* __restrict__ rows, int* __restrict__ groups,
                                   int F, int ngroups) {
  group_hulls(rows, F, ngroups, groups, threadIdx.x, blockDim.x);
}

// ------------------------------------------------------------ the split --
// crange[2g], crange[2g + 1]: group g's range in K chunks, [first, last).
// The work before chunk c: the active group-chunks of the chunks [0, c).
template <int NG>
__device__ __forceinline__ long long work_before(const int* crange, int c) {
  long long w = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    w += min(max(c - crange[2 * g], 0), crange[2 * g + 1] - crange[2 * g]);
  return w;
}

// The first chunk of split s: the least c with work_before(c) >= s / splits
// of the total. Splits that share a chunk boundary are empty.
template <int NG>
__device__ int split_begin(const int* crange, int s, int splits, int n_chunks) {
  const long long total = work_before<NG>(crange, n_chunks);
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (work_before<NG>(crange, mid) * splits >= static_cast<long long>(s) * total)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// bit g set when chunk c meets group g's range
template <int NG>
__device__ __forceinline__ unsigned active_groups(const int* crange, int c) {
  unsigned m = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    m |= (c >= crange[2 * g] && c < crange[2 * g + 1] ? 1u : 0u) << g;
  return m;
}

// ---------------------------------------------------------------- loader --
// The frame tile of the chunk at sample k0: rows r = 0..BT-1 at src + r*hop,
// 128 bytes of K each, in the 128-byte swizzle (16-byte chunk j of row r at
// j ^ (r % 8)), by asynchronous copies of VB = 16, 8 or 4 bytes. A piece of a
// row at or past `valid`, or that starts at k >= N, is zero-filled; VB
// divides N * sizeof(S), so no piece straddles N.
template <typename S, int VB>
__device__ __forceinline__ void copy_frames(const S* __restrict__ src, int hop,
                                            int valid, int N, int k0, int tid,
                                            uint32_t tile) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(S));
  constexpr int EPP = VB / static_cast<int>(sizeof(S));
#pragma unroll
  for (int i = 0; i < BT * 8 / LOADERS; ++i) {
    const int q = tid + LOADERS * i, row = q >> 3, col = q & 7;
    const uint32_t dst = tile + row * ROW_BYTES + ((col ^ (row & 7)) << 4);
#pragma unroll
    for (int p = 0; p < 16 / VB; ++p) {
      const int k = k0 + col * EPC + p * EPP;
      const bool ok = row < valid && k < N;
      const S* at = src + (ok ? row * hop + k : 0);
      if constexpr (VB == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(at), "r"(ok ? 16 : 0)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst + p * VB),
                     "l"(at), "n"(VB), "r"(ok ? VB : 0)
                     : "memory");
    }
  }
}

// The same tile of bf16 frames at addresses only 2-byte aligned, read one
// sample at a time through registers and stored.
__device__ __forceinline__ void store_frames_2b(const __nv_bfloat16* __restrict__ src,
                                                int hop, int valid, int N, int k0,
                                                int tid, unsigned char* tile) {
#pragma unroll 1
  for (int i = 0; i < BT * 8 / LOADERS; ++i) {
    const int q = tid + LOADERS * i, row = q >> 3, col = q & 7;
    uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int k = k0 + col * 8 + p;
      if (row < valid && k < N)
        r[p / 2] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(
                        src + row * hop + k)))
                    << (16 * (p & 1));
    }
    *reinterpret_cast<uint4*>(tile + row * ROW_BYTES + ((col ^ (row & 7)) << 4)) =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// Group g's packed tiles of chunk c, every plane, each one contiguous
// TILE_BYTES_G in the workspace, by one bulk copy of the copy engine whose
// bytes count on the barrier `bar`.
template <typename S, int CAP>
__device__ __forceinline__ void copy_group(const S* __restrict__ packed, long long plane,
                                           int npad, int g, int c, uint32_t stage,
                                           uint32_t bar) {
#pragma unroll
  for (int p = 0; p < Kc<S>::PLANES; ++p) {
    const S* src = packed + p * plane +
                   (static_cast<long long>(g) * npad + static_cast<long long>(c) * Kc<S>::BK) *
                       2 * GROUP;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(stage + FRAME_BYTES + p * Ring<S, CAP>::PLANE_BYTES + g * TILE_BYTES_G),
        "l"(src), "r"(TILE_BYTES_G), "r"(bar)
        : "memory");
  }
}

// -------------------------------------------------------------- products --
// One K chunk of one multiplying warpgroup: for each group active in the
// mask m, acc[g] += frames * (cos | sin rows of g)^T. acc[g][i] holds frame
// row 16 w + l/4 + 8 ((i/2) % 2) of the warpgroup (warp w, lane l) and
// packed column 8 (i/4) + 2 (l % 4) + i % 2: re of bin g*GROUP + column for
// i < GROUP / 2, im of the same bin at i + GROUP / 2.
//
// fp32 storage, 3xTF32: the frames are split a = hi + lo here, the bank was
// split by the pre-pass; per group the tensor cores sum lo*hi, hi*lo, then
// hi*hi from zero into `part` (lo*lo is dropped), and the CUDA cores add it
// to acc with round-to-nearest.
template <int CAP>
__device__ __forceinline__ void consume_chunk(const float*, uint32_t stage, unsigned m,
                                              uint32_t lane_row, uint32_t lane_swz,
                                              uint32_t lane_h,
                                              float (&acc)[CAP / GROUP][GROUP]) {
  uint32_t hi[4][4], lo[4][4];
  load_a(stage + lane_row, lane_swz, lane_h, hi);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __uint_as_float(hi[ks][j]);
      hi[ks][j] = tf32_rna(v);
      lo[ks][j] = tf32_rna(v - __uint_as_float(hi[ks][j]));
    }
  float part[GROUP];
#pragma unroll
  for (int g = 0; g < CAP / GROUP; ++g) {
    if (!((m >> g) & 1u)) continue;
    const uint32_t tile = stage + FRAME_BYTES + g * 2 * GROUP * ROW_BYTES;
    const uint64_t b_hi = tile_descriptor(tile);
    const uint64_t b_lo = tile_descriptor(tile + Ring<float, CAP>::PLANE_BYTES);
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Mma<float, 2 * GROUP>::run(part, lo[ks], b_hi + 2 * ks, ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<float, 2 * GROUP>::run(part, hi[ks], b_lo + 2 * ks, 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<float, 2 * GROUP>::run(part, hi[ks], b_hi + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
#pragma unroll
    for (int i = 0; i < GROUP; ++i) acc[g][i] += part[i];
  }
}
// bf16 storage: one product per active group, summed in `wgmma`.
template <int CAP>
__device__ __forceinline__ void consume_chunk(const __nv_bfloat16*, uint32_t stage,
                                              unsigned m, uint32_t lane_row,
                                              uint32_t lane_swz, uint32_t lane_h,
                                              float (&acc)[CAP / GROUP][GROUP]) {
  uint32_t a[4][4];
  load_a(stage + lane_row, lane_swz, lane_h, a);
  fence_registers(a);
#pragma unroll
  for (int g = 0; g < CAP / GROUP; ++g) fence_registers(acc[g]);
  wgmma_fence();
#pragma unroll
  for (int g = 0; g < CAP / GROUP; ++g) {
    if (!((m >> g) & 1u)) continue;
    const uint64_t desc = tile_descriptor(stage + FRAME_BYTES + g * 2 * GROUP * ROW_BYTES);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Mma<__nv_bfloat16, 2 * GROUP>::run(acc[g], a[ks], desc + 2 * ks, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(a);
#pragma unroll
  for (int g = 0; g < CAP / GROUP; ++g) fence_registers(acc[g]);
}

// ------------------------------------------------------------ main loop --
// grid (ceil(T/BT), splits, B); threads: two multiplying warpgroups, then
// the loading one. With one split the block stores the finished magnitude
// or power in out_re (B, F, T); with more it stores its partial sums in
// out_re, out_im (splits, B, F, T).
template <typename S, int CAP>
__global__ void __launch_bounds__(NT, 1) kchunk_tc_kernel(
    const S* __restrict__ x, const S* __restrict__ packed, const int* __restrict__ rows,
    float* __restrict__ out_re, float* __restrict__ out_im,
    int L, int N, int npad, int hop, int F, int T, int splits, float eps, int square,
    int vb_x) {
  constexpr int NG = CAP / GROUP;
  constexpr int BK = Kc<S>::BK;
  constexpr int STAGES = Ring<S, CAP>::STAGES;
  constexpr int STAGE_BYTES = Ring<S, CAP>::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t barriers[2 * STAGES];  // full, then empty, per stage
  __shared__ int hull[2 * NG], crange[2 * NG];
  // the swizzle pattern repeats every 1024 bytes of shared address
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(barriers));
  const uint32_t empty = full + 8 * STAGES;

  const int b = blockIdx.z, split = blockIdx.y, t0 = blockIdx.x * BT;
  const int wg = threadIdx.x / 128;
  // multiplying warpgroups with frames: the second has none when T - t0 <= 64
  const int consumers = t0 + 64 < T ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // every loader arrives twice: behind its copies, and after its stores
      mbar_init(full + 8 * s, 2 * LOADERS);
      mbar_init(empty + 8 * s, 128 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  group_hulls(rows, F, NG, hull, threadIdx.x, NT);
  __syncthreads();
  if (threadIdx.x < 2 * NG) {
    const int v = hull[threadIdx.x];
    crange[threadIdx.x] = threadIdx.x % 2 ? (v + BK - 1) / BK : v / BK;
  }
  __syncthreads();
  const int n_chunks = npad / BK;
  const int c_begin = split_begin<NG>(crange, split, splits, n_chunks);
  const int c_end =
      split + 1 < splits ? split_begin<NG>(crange, split + 1, splits, n_chunks) : n_chunks;

  if (wg == 2) {
    // ---- the loading warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    const int tid = threadIdx.x - 256;
    const S* xt = x + static_cast<long long>(b) * L + static_cast<long long>(t0) * hop;
    const long long plane = 2LL * CAP * npad;
    int j = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const unsigned m = active_groups<NG>(crange, c);
      if (!m) continue;
      const int s = j % STAGES, k0 = c * BK;
      const uint32_t stage = smem_addr + s * STAGE_BYTES;
      mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
      if (tid == 0) {
        const uint32_t bytes = Kc<S>::PLANES * __popc(m) * TILE_BYTES_G;
        mbar_expect_bytes(full + 8 * s, bytes);
        for (int g = 0; g < NG; ++g)
          if ((m >> g) & 1u) copy_group<S, CAP>(packed, plane, npad, g, c, stage, full + 8 * s);
      }
      if (vb_x == 16) copy_frames<S, 16>(xt, hop, T - t0, N, k0, tid, stage);
      else if (vb_x == 8) copy_frames<S, 8>(xt, hop, T - t0, N, k0, tid, stage);
      else if (vb_x == 4) copy_frames<S, 4>(xt, hop, T - t0, N, k0, tid, stage);
      mbar_arrive_after_copies(full + 8 * s);
      if constexpr (sizeof(S) == 2) {
        if (vb_x < 4)
          store_frames_2b(xt, hop, T - t0, N, k0, tid, smem + s * STAGE_BYTES);
      }
      mbar_arrive(full + 8 * s);
      ++j;
    }
    return;
  }

  // ---- a multiplying warpgroup: frames [t0 + 64 wg, t0 + 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MULTIPLIER_REGS));
  if (wg >= consumers) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // the frame row whose address this lane gives `ldmatrix` (see load_a)
  const uint32_t lane_row = (64 * wg + 16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * ROW_BYTES;
  const uint32_t lane_swz = lane % 8, lane_h = lane / 16;
  float acc[NG][GROUP];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < GROUP; ++i) acc[g][i] = 0.f;
  int j = 0;
  for (int c = c_begin; c < c_end; ++c) {
    const unsigned m = active_groups<NG>(crange, c);
    if (!m) continue;
    const int s = j % STAGES;
    mbar_wait(full + 8 * s, (j / STAGES) & 1);
    // the stage was written through the generic proxy (copies, stores) and
    // the tensor cores read it through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consume_chunk<CAP>(static_cast<const S*>(nullptr), smem_addr + s * STAGE_BYTES, m,
                       lane_row, lane_swz, lane_h, acc);
    mbar_arrive(empty + 8 * s);
    ++j;
  }

  // Every bin of every group leaves the block, zeros for the groups no chunk
  // of this split met. A store instruction writes 8 consecutive frames of
  // each of 4 bins: whole 32-byte sectors.
  const int frame = t0 + 64 * wg + 16 * warp + lane / 4;
  const long long base = static_cast<long long>(splits > 1 ? split * gridDim.z + b : b) * F;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < GROUP / 2; ++i) {
      const int f = g * GROUP + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const int t = frame + 8 * ((i / 2) % 2);
      if (f >= F || t >= T) continue;
      const float re = acc[g][i], im = acc[g][i + GROUP / 2];
      const long long o = (base + f) * T + t;
      if (splits > 1) {
        out_re[o] = re;
        out_im[o] = im;
      } else {
        const float p = re * re + im * im + eps;
        out_re[o] = square ? p : sqrtf(p);
      }
    }
}

// Second pass: the splits summed in index order, then the epilogue. One
// thread per output element, grid-stride.
__global__ void __launch_bounds__(256) kchunk_reduce_kernel(
    const float* __restrict__ ws_re, const float* __restrict__ ws_im,
    float* __restrict__ out, long long n, int splits, float eps, int square) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    float re = 0.f, im = 0.f;
    for (int s = 0; s < splits; ++s) {
      re += ws_re[static_cast<long long>(s) * n + o];
      im += ws_im[static_cast<long long>(s) * n + o];
    }
    const float p = re * re + im * im + eps;
    out[o] = square ? p : sqrtf(p);
  }
}

// ---------------------------------------------------------------- launch --
// the widest piece (16, 8, 4 or 2 bytes) that divides every address in `bits`
int piece_bytes(uintptr_t bits) {
  if (bits % 16 == 0) return 16;
  if (bits % 8 == 0) return 8;
  if (bits % 4 == 0) return 4;
  return 2;
}

template <typename S>
cudaError_t pack(const void* wcos, const void* wsin, unsigned char* work, const Layout& lay,
                 int F, int N, cudaStream_t st) {
  kchunk_pack_kernel<S><<<lay.cap, PACK_THREADS, 0, st>>>(
      static_cast<const S*>(wcos), static_cast<const S*>(wsin),
      reinterpret_cast<S*>(work + lay.packed_off), reinterpret_cast<int*>(work), F, N,
      lay.npad, lay.cap);
  return cudaGetLastError();
}

template <typename S, int CAP>
cudaError_t launch_cap(const void* x, const void* wcos, const void* wsin, void* out,
                       unsigned char* work, const Layout& lay, int B, int L, int N,
                       int hop, int F, int T, int splits, float eps, int square,
                       cudaStream_t st) {
  cudaError_t err = pack<S>(wcos, wsin, work, lay, F, N, st);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kchunk_tc_kernel<S, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<S, CAP>::SMEM);
  if (err != cudaSuccess) return err;
  const uintptr_t es = sizeof(S);
  const int vb_x = piece_bytes(reinterpret_cast<uintptr_t>(x) | (L * es) | (hop * es) |
                               (N * es));
  const long long n = static_cast<long long>(B) * F * T;
  float* re = splits > 1 ? reinterpret_cast<float*>(work + lay.partial_off)
                         : static_cast<float*>(out);
  float* im = splits > 1 ? re + splits * n : nullptr;
  const dim3 grid((T + BT - 1) / BT, splits, B);
  kchunk_tc_kernel<S, CAP><<<grid, NT, Ring<S, CAP>::SMEM, st>>>(
      static_cast<const S*>(x), reinterpret_cast<const S*>(work + lay.packed_off),
      reinterpret_cast<const int*>(work), re, im, L, N, lay.npad, hop, F, T, splits, eps,
      square, vb_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  kchunk_reduce_kernel<<<blocks, 256, 0, st>>>(re, im, static_cast<float*>(out), n, splits,
                                               eps, square);
  return cudaGetLastError();
}

// the narrowest bank capacity (CAP bins, CAP / GROUP groups) that holds F
template <typename S>
cudaError_t launch(const void* x, const void* wcos, const void* wsin, void* out,
                   unsigned char* work, const Layout& lay, int B, int L, int N, int hop,
                   int F, int T, int splits, float eps, int square, cudaStream_t st) {
  if (lay.cap == 32)
    return launch_cap<S, 32>(x, wcos, wsin, out, work, lay, B, L, N, hop, F, T, splits, eps, square, st);
  if (lay.cap == 64)
    return launch_cap<S, 64>(x, wcos, wsin, out, work, lay, B, L, N, hop, F, T, splits, eps, square, st);
  if (lay.cap == 96)
    return launch_cap<S, 96>(x, wcos, wsin, out, work, lay, B, L, N, hop, F, T, splits, eps, square, st);
  return launch_cap<S, 128>(x, wcos, wsin, out, work, lay, B, L, N, hop, F, T, splits, eps, square, st);
}

}  // namespace

// out (B, F, T) fp32. work: work_bytes of device memory, at least what
// layout() asks for (the wrapper computes the same size). splits >= 1; a
// split may come out empty.
extern "C" int nnaudio_framed_magnitude_kchunk(
    const void* x, const void* wcos, const void* wsin, void* out, void* work,
    long long work_bytes, int B, int L, int N, int hop, int F, int T, int splits,
    float eps, int square, int bf16, void* stream) {
  if (F < 1 || F > MAX_F || B < 1 || T < 1 || N < 1 || hop < 1 || splits < 1 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  const Layout lay = layout(B, F, N, T, splits, bf16);
  if (work_bytes < lay.bytes) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  if (bf16)
    return launch<__nv_bfloat16>(x, wcos, wsin, out, w, lay, B, L, N, hop, F, T, splits,
                                 eps, square, st);
  return launch<float>(x, wcos, wsin, out, w, lay, B, L, N, hop, F, T, splits, eps, square,
                       st);
}

// The pre-pass alone, for inspection: the group ranges [k_lo, k_hi) of the
// bank as int32 pairs at byte GROUP_RANGES of work, CAP / GROUP of them.
// group must be this build's GROUP.
extern "C" int nnaudio_kchunk_ranges(const void* wcos, const void* wsin, void* work,
                                     long long work_bytes, int F, int N, int bf16,
                                     int group, void* stream) {
  if (group != GROUP || F < 1 || F > MAX_F || N < 1) return cudaErrorInvalidValue;
  const Layout lay = layout(1, F, N, 1, 1, bf16);
  if (work_bytes < lay.bytes) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  cudaError_t err = bf16 ? pack<__nv_bfloat16>(wcos, wsin, w, lay, F, N, st)
                         : pack<float>(wcos, wsin, w, lay, F, N, st);
  if (err != cudaSuccess) return err;
  kchunk_hull_kernel<<<1, 32, 0, st>>>(reinterpret_cast<const int*>(w),
                                       reinterpret_cast<int*>(w + GROUP_RANGES), F,
                                       lay.cap / GROUP);
  return cudaGetLastError();
}
