// Framed analysis on Hopper's tensor cores (sm_90a): one `wgmma` main loop
// with four epilogues, for four kernels of the STFT family.
//
// Replaces nnaudio_tpu/ops/framed_matmul.py:
//   K5  _pair_kernel        :205  (launched by _framed_analysis, pair=True)
//   K4  _gl_step_kernel     :239  (launched by _framed_gl_step)
//   K1  _magnitude_kernel   :273  (launched by _framed_analysis, pair=False)
//   K2  _filterbank_kernel  :296  (launched by _framed_filterbank)
//
// For the cos and sin bases (F, N) and a signal x (B, L), any hop >= 1,
//   re[b,f,t] = sum_k x[b, t*hop + k] * wcos[f,k]
//   im[b,f,t] = sum_k x[b, t*hop + k] * wsin[f,k]
// and then, by epilogue:
// - PAIR (K5) stores (re, im) as two (B, F, T) fp32 arrays;
// - MAGNITUDE / POWER (K1) store sqrt(re^2 + im^2 + eps), or the power;
// - FILTERBANK (K2) projects the power onto a filterbank fb (M, F),
//   out[b,m,t] = sum_f fb[m,f] * (re^2 + im^2 + eps): the (B, F, T) power
//   never reaches device memory;
// - GL_STEP (K4) is one Griffin-Lim iteration's analysis half: with
//   r = (re, -im), n = r - mom * p and c = S * n * rsqrt(|n|^2 + 1e-32), it
//   stores the next loop carries c_re, c_im, r_re, r_im in the carry type C
//   (fp32 or bf16), reading p (type C) and S (fp32) at the same (b,f,t). It
//   writes fresh outputs (r is not written over p).
//
// Per batch item the pair is a GEMM D (F x T) = W (F x N) * X^T, where the
// frame matrix X[t,k] = x[t*hop + k] is a strided, overlapping view of the
// signal that never exists in device memory. Both operands are K-major,
// which is what `wgmma` wants of a shared-memory operand in TF32.
//
// What bounds each on the H100 (dense tensor-core peaks 495 TFLOP/s in TF32,
// 989 in bf16; 3.35 TB/s HBM), counting 4*B*T*F*N flops for the pair,
// 2*B*T*F*M for the projection, each input read once and each output
// written once:
// - K1 / K5 at B=32, T=431, F=1025, N=2048: 115.8 GFLOP over ~102 MB (K1)
//   or ~158 MB (K5): operations, 0.234 ms for one TF32 product, 0.70 ms for
//   the three products that keep fp32 accuracy, 0.117 ms in bf16.
// - K2 at B=32, T=626, F=513, M=64, N=1024: 43.4 GFLOP over ~27 MB:
//   operations, 0.088 ms in TF32, 0.044 ms in bf16.
// - K4 at B=32, T=862, F=513, N=1024: 58.0 GFLOP; with bf16 storage and
//   carries ~243 MB (S in fp32, two carries in and four out): bytes, 0.072
//   ms (the products alone 0.059 ms); in fp32 storage operations, 0.117 ms.
// A 128 x 112 tile reads 368 operand rows of 128 bytes per K chunk: 3.5 GB
// through L2 at K1's shape in fp32 and 1.7 GB in bf16, where moving them
// takes longer than the products do.
//
// Design:
// - A block owns 128 bins x BT frames of one batch item (BT = 128, 112 or 64,
//   chosen per launch so that the frame tiles waste least of T; 128 only in
//   bf16). It runs four warpgroups: two multiply, two load.
// - Multiplying warpgroup w takes bins [64w, 64w+64) of the cos and of the sin
//   tile against the one shared frame tile: `wgmma` m64nBTk8 (TF32) or
//   m64nBTk16 (bf16) with A (the basis) from registers and B (the frames)
//   from shared memory, fp32 accumulators in registers, BT/2 each for re and
//   im, which land in the same thread, so every epilogue starts from
//   registers. A warpgroup whose 64 bins all lie past F leaves at once.
// - Precision by storage type. fp32 storage: 3xTF32. Each operand is split
//   a = hi + lo, hi = tf32_rna(a), lo = tf32_rna(a - hi), in registers: the
//   frames by the loaders on the way into shared memory, the basis by the
//   multiplying thread that holds it. Per K chunk the tensor cores sum
//   lo*hi, then hi*lo, then hi*hi from zero (lo*lo is dropped), and the CUDA
//   cores add that partial sum to the running one: see consume_stage for
//   why. bf16 storage: one bf16 product, summed in `wgmma`.
// - A ring of stages in dynamic shared memory (fp32: 3 of 64 KB, bf16: 4 of
//   48 KB), handed over by `mbarrier`s: `full` counts the loaders' arrivals,
//   one behind each thread's asynchronous copies and one after its stores,
//   and the bytes of the TMA loads; `empty` the multiplying threads'. Rows
//   are 128 bytes (32 fp32 or 64 bf16 samples of K). The frame tile lies in
//   the 128-byte swizzle `wgmma` reads (16-byte chunk j of row r at chunk
//   j ^ (r % 8)); the basis tiles use the same pattern so that the
//   `ldmatrix` reads of the A registers hit 32 banks.
// - The loaders take any hop, N, F, T and any pointer alignment, and every
//   route leaves zeros for t >= T, k >= N and f >= F. The bases go by TMA, one
//   128-row box per tile from a tensor map over (F, N) with the 128-byte
//   swizzle, whenever their rows are 16-byte aligned. The bf16 frame tile
//   goes by `cp.async` in pieces of 16, 8 or 4 bytes, the widest that its
//   addresses (pointer, L, hop, N) allow. The fp32 frames, bf16 frames at odd
//   addresses and bases at rows TMA cannot take pass through registers, read
//   in the widest pieces their addresses allow down to one sample; for the
//   frames chunk c + 1 is read while chunk c is stored. TMA cannot serve the
//   frame tile at an odd hop or batch-row base, nor split fp32 on the way.
//   Eight loading warps, not four: a warp keeps few copies in flight, and
//   with four the ring ran dry.
// - PAIR, MAGNITUDE, POWER and GL_STEP park each warp's 16 bins x BT frames
//   in the ring, once it is free (GL_STEP both re and im: 2 x 16 x (BT + 4)
//   floats a warp, at most 135 KB), and walk them row by row, 32
//   consecutive frames at a time: GL_STEP reads p and S and writes its four
//   carries in the same coalesced rows.
// - FILTERBANK. Each multiplying thread turns its re, im into the power of
//   its bins and parks it in the ring as the K-major operand [frame][bin] of
//   a second product, in the same swizzle: 32-bin tiles in hi and lo planes
//   (fp32) or 64-bin tiles rounded to bf16, as the TPU kernel's DEFAULT-
//   precision dot rounds it. The block then projects its 128 bins,
//   D (64 mels x BT) = fb[m0:m0+64, f0:f0+128] * P^T, the 64-row m-tiles of
//   M dealt to the warpgroups in turn. fb is the A operand, read from L2
//   into registers and, in fp32, split as the basis is; each 32-bin chunk is
//   summed from zero and added on the CUDA cores, as in consume_stage. Bins
//   at or past F meet zero fb columns. Each block writes its M x BT partial
//   sum to an fp32 workspace (ceil(F/128), B, M, Tp), Tp = T rounded up to
//   8, and filterbank_reduce_kernel sums the bin tiles in index order into
//   (B, M, T). The workspace is 26 MB at K2's shape above. The alternative,
//   each block walking all of F itself, has no registers for it (the fp32
//   loop at BT = 112 holds 200 of a multiplying thread's 216) and would
//   leave B * ceil(T/BT) blocks, under one wave at B=32, T=431.
// - Deterministic: fixed summation order, no atomics, no library call.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode).
// Launchers return cudaError_t.

#include "tc_common.cuh"

namespace {

constexpr int NT = 512;               // two multiplying warpgroups, then two loading ones
constexpr int LOADERS = 256;          // threads of the loading warpgroups
constexpr int BM = 128;               // bins per block, 64 per warpgroup
constexpr int TILE_CHUNKS = 4;        // 16-byte chunks of one tile a loader thread moves

enum Epilogue { PAIR = 0, MAGNITUDE = 1, POWER = 2, FILTERBANK = 3, GL_STEP = 4 };

// The operands of FILTERBANK and GL_STEP, passed by value.
struct EpilogueArgs {
  const void* fbT;    // FILTERBANK: the filterbank transposed, (F, M), type S
  float* work;        // FILTERBANK: partial sums, (ceil(F/128), B, M, Tp)
  int M, Tp;
  const float* mag;   // GL_STEP: the target magnitudes S, (B, F, T)
  const void* p_re;   // GL_STEP: the previous analysis, (B, F, T), type C
  const void* p_im;
  void* c_re;         // GL_STEP: the four carries out, (B, F, T), type C
  void* c_im;
  void* r_re;
  void* r_im;
  float mom;
  int carry_bf16;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// A stage holds the cos and the sin tile as they are in memory and the frame
// tile in PLANES planes (fp32: hi and lo).
//
// Registers per thread after `setmaxnreg`, multiplying + loading warpgroups:
// 256 * (MULTIPLIER_REGS + LOADER_REGS) = 65,536, the 512 * 128 that the
// block is launched with. fp32 at BT = 112 holds re, im and the chunk sum
// (3 * 56) and 32 fragment registers: at 208 it spilled five accumulators
// every K chunk, at 216 none, and its loaders' spills at 40 cost less than
// that (5% faster at K1's shape). bf16 fits 208 and its loaders need 48.
template <typename S> struct Storage;
template <> struct Storage<float> {
  static constexpr int PLANES = 2;
  static constexpr int BK = 32;       // samples of K per 128-byte row
  static constexpr int STAGES = 3;    // 64 KB each
  static constexpr int MULTIPLIER_REGS = 216;
  static constexpr int LOADER_REGS = 40;
};
template <> struct Storage<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;    // 48 KB each
  static constexpr int MULTIPLIER_REGS = 208;
  static constexpr int LOADER_REGS = 48;
};

// ----------------------------------------------------------------- loader --
// 16 bytes starting at src[at], sample k of a row, read in pieces of VB
// bytes; a piece of a row that is masked, or that starts at k >= N, is zero.
// VB divides the byte address of every piece and N * sizeof(S), so no piece
// straddles N.
template <typename S, int VB>
__device__ __forceinline__ void load16(const S* __restrict__ src, int at0, int k,
                                       int N, bool row_ok, uint32_t (&r)[4]) {
  constexpr int EPP = VB / static_cast<int>(sizeof(S));  // elements per piece
  r[0] = r[1] = r[2] = r[3] = 0u;
#pragma unroll
  for (int p = 0; p < 16 / VB; ++p) {
    if (!(row_ok && k + p * EPP < N)) continue;
    const S* at = src + (at0 + p * EPP);
    if constexpr (VB == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(at));
      r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else if constexpr (VB == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(at));
      r[2 * p] = v.x; r[2 * p + 1] = v.y;
    } else if constexpr (VB == 4) {
      r[p] = __ldg(reinterpret_cast<const unsigned int*>(at));
    } else {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned short*>(at));
      r[p / 2] |= v << (16 * (p & 1));
    }
  }
}

// Chunk i (0..3) of a loader thread in a 128-row tile: row and 16-byte
// column. Eight consecutive threads read one 128-byte row.
__device__ __forceinline__ void chunk_coords(int tid, int i, int& row, int& col) {
  const int q = tid + LOADERS * i;
  row = q >> 3;
  col = q & 7;
}

// One tile of one K chunk, global memory -> registers: ROWS rows starting
// `stride` elements apart at `src`, of which the first `valid` are real.
template <typename S, int ROWS, int VB>
__device__ __forceinline__ void load_tile_vb(const S* __restrict__ src,
                                             int stride, int valid, int N,
                                             int k0, int tid,
                                             uint32_t (&stg)[TILE_CHUNKS][4]) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(S));
#pragma unroll
  for (int i = 0; i < TILE_CHUNKS; ++i) {
    if (32 * i >= ROWS) continue;  // rows the products never read
    int row, col;
    chunk_coords(tid, i, row, col);
    // offsets inside a tile fit 32 bits: at most 128 rows of `stride`
    load16<S, VB>(src, row * stride + k0 + col * EPC, k0 + col * EPC, N,
                  row < ROWS && row < valid, stg[i]);
  }
}

template <typename S, int ROWS>
__device__ __forceinline__ void load_tile(const S* __restrict__ src,
                                          int stride, int valid, int N,
                                          int k0, int vb, int tid,
                                          uint32_t (&stg)[TILE_CHUNKS][4]) {
  if (vb == 16) load_tile_vb<S, ROWS, 16>(src, stride, valid, N, k0, tid, stg);
  else if (vb == 8) load_tile_vb<S, ROWS, 8>(src, stride, valid, N, k0, tid, stg);
  else if (vb == 4) load_tile_vb<S, ROWS, 4>(src, stride, valid, N, k0, tid, stg);
  else if constexpr (sizeof(S) == 2)
    load_tile_vb<S, ROWS, 2>(src, stride, valid, N, k0, tid, stg);
}

// Registers -> one tile of a stage of shared memory, swizzled. With SPLIT an
// fp32 tile goes into a hi plane and, TILE_BYTES behind it, a lo plane.
template <typename S, int ROWS, bool SPLIT>
__device__ __forceinline__ void store_tile(unsigned char* tile, int tid,
                                           const uint32_t (&stg)[TILE_CHUNKS][4]) {
#pragma unroll
  for (int i = 0; i < TILE_CHUNKS; ++i) {
    if (32 * i >= ROWS) continue;
    int row, col;
    chunk_coords(tid, i, row, col);
    if (row >= ROWS) continue;
    unsigned char* at = tile + row * ROW_BYTES + ((col ^ (row & 7)) << 4);
    if constexpr (SPLIT && sizeof(S) == 4) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(stg[i][e]);
        hi[e] = tf32_rna(v);
        lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
      }
      *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(at + TILE_BYTES) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      *reinterpret_cast<uint4*>(at) =
          make_uint4(stg[i][0], stg[i][1], stg[i][2], stg[i][3]);
    }
  }
}

// One tile of one K chunk, global -> shared memory as it is in memory, by
// asynchronous copies of VB = 16, 8 or 4 bytes; a piece of a masked row, or
// one that starts at k >= N, is zero-filled.
template <typename S, int ROWS, int VB>
__device__ __forceinline__ void copy_tile_vb(const S* __restrict__ src, int stride,
                                             int valid, int N, int k0, int tid,
                                             uint32_t tile_addr) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(S));
  constexpr int EPP = VB / static_cast<int>(sizeof(S));
#pragma unroll
  for (int i = 0; i < TILE_CHUNKS; ++i) {
    if (32 * i >= ROWS) continue;
    int row, col;
    chunk_coords(tid, i, row, col);
    if (row >= ROWS) continue;
    const uint32_t dst = tile_addr + row * ROW_BYTES + ((col ^ (row & 7)) << 4);
#pragma unroll
    for (int p = 0; p < 16 / VB; ++p) {
      const int k = k0 + col * EPC + p * EPP;
      const bool ok = row < valid && k < N;
      const S* at = src + (ok ? row * stride + k : 0);
      if constexpr (VB == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(at), "r"(ok ? 16 : 0)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                         dst + p * VB),
                     "l"(at), "n"(VB), "r"(ok ? VB : 0)
                     : "memory");
    }
  }
}

template <typename S, int ROWS>
__device__ __forceinline__ void copy_tile(const S* __restrict__ src, int stride,
                                          int valid, int N, int k0, int vb,
                                          int tid, uint32_t tile_addr) {
  if (vb == 16) copy_tile_vb<S, ROWS, 16>(src, stride, valid, N, k0, tid, tile_addr);
  else if (vb == 8) copy_tile_vb<S, ROWS, 8>(src, stride, valid, N, k0, tid, tile_addr);
  else copy_tile_vb<S, ROWS, 4>(src, stride, valid, N, k0, tid, tile_addr);
}

// --------------------------------------------------------------- products --
// One K chunk of one warpgroup from one stage: re += cos * frames^T,
// im += sin * frames^T.
//
// fp32 storage, 3xTF32: both operands are split a = hi + lo (the basis here,
// in registers; the frames by the loader), and each chunk of each basis is
// summed by the tensor cores into `part` from zero, the small terms first:
// lo*hi, hi*lo, then hi*hi; lo*lo is dropped. The CUDA cores add `part` to the
// running sum with round-to-nearest. Inside `wgmma` an fp32 sum is cut off,
// not rounded, so 3 * N / 8 accumulations in one chain drift toward zero:
// measured 1.5e-5 of max |re| at N = 2048, eight times the error of an fp32
// FMA loop, and over 1e-4 at N = 16384. Twelve accumulations per chunk do not
// (3.5e-7 at N = 2048).
template <int BT>
__device__ __forceinline__ void consume_stage(const float*, uint32_t stage,
                                              uint32_t lane_row, uint32_t lane_swz,
                                              uint32_t lane_h, float (&re)[BT / 2],
                                              float (&im)[BT / 2]) {
  const uint64_t x_hi = tile_descriptor(stage + 2 * TILE_BYTES);
  const uint64_t x_lo = tile_descriptor(stage + 3 * TILE_BYTES);
  float part[BT / 2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int basis = 0; basis < 2; ++basis) {
    load_a(stage + basis * TILE_BYTES + lane_row, lane_swz, lane_h, hi);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = __uint_as_float(hi[ks][j]);
        hi[ks][j] = tf32_rna(v);
        lo[ks][j] = tf32_rna(v - __uint_as_float(hi[ks][j]));
      }
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Mma<float, BT>::run(part, lo[ks], x_hi + 2 * ks, ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Mma<float, BT>::run(part, hi[ks], x_lo + 2 * ks, 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Mma<float, BT>::run(part, hi[ks], x_hi + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) (basis ? im : re)[i] += part[i];
  }
}
// bf16 storage: one product, summed in `wgmma`.
template <int BT>
__device__ __forceinline__ void consume_stage(const __nv_bfloat16*, uint32_t stage,
                                              uint32_t lane_row, uint32_t lane_swz,
                                              uint32_t lane_h, float (&re)[BT / 2],
                                              float (&im)[BT / 2]) {
  const uint64_t x = tile_descriptor(stage + 2 * TILE_BYTES);
  uint32_t c[4][4], s[4][4];
  load_a(stage + lane_row, lane_swz, lane_h, c);
  load_a(stage + TILE_BYTES + lane_row, lane_swz, lane_h, s);
  fence_registers(re);
  fence_registers(im);
  fence_registers(c);
  fence_registers(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    Mma<__nv_bfloat16, BT>::run(re, c[ks], x + 2 * ks, 1);
    Mma<__nv_bfloat16, BT>::run(im, s[ks], x + 2 * ks, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(re);
  fence_registers(im);
  fence_registers(c);
  fence_registers(s);
}

// ------------------------------------------------------------- FILTERBANK --
// The power of a thread's accumulators, parked as the B operand of the
// projection: tile rows are frames, K is bins, in the 128-byte swizzle.
// Accumulator i of lane l of warp w of warpgroup g holds bin
// 64g + 16w + l/4 + 8*((i/2)%2) of the block and frame 8*(i/4) + 2*(l%4) + i%2.
// fp32: 32-bin tiles, the hi plane at tile 2c and the lo plane at 2c + 1.
template <int BT>
__device__ __forceinline__ void park_power(const float*, const float (&re)[BT / 2],
                                           const float (&im)[BT / 2],
                                           unsigned char* tiles, int bin0,
                                           int lane, float eps) {
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    const int bin = bin0 + lane / 4 + 8 * ((i / 2) % 2), kk = bin & 31;
    const int frame = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    const float p = re[i] * re[i] + im[i] * im[i] + eps;
    const uint32_t hi = tf32_rna(p), lo = tf32_rna(p - __uint_as_float(hi));
    unsigned char* at = tiles + 2 * (bin >> 5) * TILE_BYTES + frame * ROW_BYTES +
                        ((((kk >> 2) ^ (frame & 7)) << 4) | ((kk & 3) << 2));
    *reinterpret_cast<uint32_t*>(at) = hi;
    *reinterpret_cast<uint32_t*>(at + TILE_BYTES) = lo;
  }
}
// bf16: 64-bin tiles, the power rounded to bf16
template <int BT>
__device__ __forceinline__ void park_power(const __nv_bfloat16*,
                                           const float (&re)[BT / 2],
                                           const float (&im)[BT / 2],
                                           unsigned char* tiles, int bin0,
                                           int lane, float eps) {
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    const int bin = bin0 + lane / 4 + 8 * ((i / 2) % 2), kk = bin & 63;
    const int frame = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    const float p = re[i] * re[i] + im[i] * im[i] + eps;
    unsigned char* at = tiles + (bin >> 6) * TILE_BYTES + frame * ROW_BYTES +
                        ((((kk >> 3) ^ (frame & 7)) << 4) | ((kk & 7) << 1));
    *reinterpret_cast<__nv_bfloat16*>(at) = __float2bfloat16(p);
  }
}

// fb[m, f] from the transposed filterbank, zero outside (F, M)
__device__ __forceinline__ float fb_value(const float* __restrict__ fbT, int f,
                                          int m, int F, int M) {
  return f < F && m < M ? __ldg(fbT + static_cast<long long>(f) * M + m) : 0.f;
}
__device__ __forceinline__ uint32_t fb_bits(const __nv_bfloat16* __restrict__ fbT,
                                            int f, int m, int F, int M) {
  return f < F && m < M
             ? static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(fbT) +
                                           static_cast<long long>(f) * M + m))
             : 0u;
}

// acc (64 mels x BT frames) += fb[m-tile, f0:f0+128] * P^T for the bins
// below F. `m_row` is the thread's mel row g of the tile (the A rows are
// m_row and m_row + 8), `tiles` the shared address of the parked power.
// fp32: per 32-bin chunk lo*hi, hi*lo, hi*hi summed from zero, then added to
// acc on the CUDA cores, as in consume_stage.
template <int BT>
__device__ __forceinline__ void project_power(const float* __restrict__ fbT,
                                              uint32_t tiles, int F, int M,
                                              int f0, int m_row, int lane,
                                              float (&acc)[BT / 2]) {
  float part[BT / 2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll 1
  for (int c = 0; c < 4 && f0 + 32 * c < F; ++c) {
    // A registers (row, bin) of K step ks: (g, k), (g + 8, k), (g, k + 4),
    // (g + 8, k + 4) at k = 8 ks + lane % 4
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = fb_value(fbT, f0 + 32 * c + 8 * ks + lane % 4 + 4 * (j / 2),
                                 m_row + 8 * (j % 2), F, M);
        hi[ks][j] = tf32_rna(v);
        lo[ks][j] = tf32_rna(v - __uint_as_float(hi[ks][j]));
      }
    const uint64_t p_hi = tile_descriptor(tiles + 2 * c * TILE_BYTES);
    const uint64_t p_lo = tile_descriptor(tiles + (2 * c + 1) * TILE_BYTES);
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, lo[ks], p_hi + 2 * ks, ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, hi[ks], p_lo + 2 * ks, 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, hi[ks], p_hi + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(part);
    fence_registers(hi);
    fence_registers(lo);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] += part[i];
  }
}
// bf16: one product per 64-bin chunk, summed in `wgmma`. A register j of K
// step ks holds the bins k and k + 1, k = 16 ks + 2 (lane % 4) + 8 (j / 2),
// the lower in the low half.
template <int BT>
__device__ __forceinline__ void project_power(const __nv_bfloat16* __restrict__ fbT,
                                              uint32_t tiles, int F, int M,
                                              int f0, int m_row, int lane,
                                              float (&acc)[BT / 2]) {
  uint32_t a[4][4];
#pragma unroll 1
  for (int c = 0; c < 2 && f0 + 64 * c < F; ++c) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + 64 * c + 16 * ks + 2 * (lane % 4) + 8 * (j / 2);
        const int m = m_row + 8 * (j % 2);
        a[ks][j] = fb_bits(fbT, f, m, F, M) | (fb_bits(fbT, f + 1, m, F, M) << 16);
      }
    const uint64_t p = tile_descriptor(tiles + c * TILE_BYTES);
    fence_registers(acc);
    fence_registers(a);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<__nv_bfloat16, BT>::run(acc, a[ks], p + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_registers(acc);
    fence_registers(a);
  }
}

// out[b,m,t] = sum over the bin tiles j, in order, of work[j,b,m,t]
__global__ void filterbank_reduce_kernel(const float* __restrict__ work,
                                         float* __restrict__ out, int tiles,
                                         long long rows, int T, int Tp) {
  const long long n = rows * T, tile_stride = rows * Tp;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / T;
    const float* w = work + row * Tp + (e - row * T);
    float s = w[0];
    for (int j = 1; j < tiles; ++j) s += w[j * tile_stride];
    out[e] = s;
  }
}

// ---------------------------------------------------------------- GL_STEP --
// The Griffin-Lim update of a warp's parked 16 bins x BT frames (re at
// `park`, im 16 rows below), 32 consecutive frames of a row a step, in
// batches of eight steps whose loads of p and S are all issued before the
// first is used: one step at a time left a warp a single load in flight.
template <typename C, int BT>
__device__ __forceinline__ void gl_step_rows(const float* park, const EpilogueArgs& ep,
                                             long long base, int f_warp, int F,
                                             int T, int t0, int lane) {
  constexpr int PITCH = BT + 4, COLS = (BT + 31) / 32, BATCH = 8;
  const C* p_re = static_cast<const C*>(ep.p_re);
  const C* p_im = static_cast<const C*>(ep.p_im);
#pragma unroll 1
  for (int i0 = 0; i0 < 16 * COLS; i0 += BATCH) {
    float pr[BATCH], pi[BATCH], mag[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int row = (i0 + j) / COLS, col = lane + 32 * ((i0 + j) % COLS);
      const long long o = base + static_cast<long long>(row) * T + col;
      const bool ok = f_warp + row < F && col < BT && t0 + col < T;
      pr[j] = ok ? to_float(p_re[o]) : 0.f;
      pi[j] = ok ? to_float(p_im[o]) : 0.f;
      mag[j] = ok ? ep.mag[o] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int row = (i0 + j) / COLS, col = lane + 32 * ((i0 + j) % COLS);
      if (!(f_warp + row < F && col < BT && t0 + col < T)) continue;
      const long long o = base + static_cast<long long>(row) * T + col;
      const float rr = park[row * PITCH + col];
      const float ri = -park[(16 + row) * PITCH + col];  // reference sign convention
      const float nr = rr - ep.mom * pr[j];
      const float ni = ri - ep.mom * pi[j];
      const float scale = mag[j] * rsqrtf(nr * nr + ni * ni + 1e-32f);
      store_as(static_cast<C*>(ep.c_re) + o, nr * scale);
      store_as(static_cast<C*>(ep.c_im) + o, ni * scale);
      store_as(static_cast<C*>(ep.r_re) + o, rr);
      store_as(static_cast<C*>(ep.r_im) + o, ri);
    }
  }
}

// grid (ceil(T/BT), ceil(F/128), B); threads: two multiplying warpgroups,
// then two loading ones
template <typename S, int BT>
__global__ void __launch_bounds__(NT, 1) framed_tc_kernel(
    const S* __restrict__ x, const S* __restrict__ wcos,
    const S* __restrict__ wsin, float* __restrict__ out0,
    float* __restrict__ out1, int L, int N, int hop, int F, int T, float eps,
    int epilogue, int vb_w, int vb_x, int use_tma,
    const __grid_constant__ EpilogueArgs ep,
    const __grid_constant__ CUtensorMap map_cos,
    const __grid_constant__ CUtensorMap map_sin) {
  constexpr int BK = Storage<S>::BK;
  constexpr int PL = Storage<S>::PLANES;
  constexpr int STAGES = Storage<S>::STAGES;
  constexpr int STAGE_BYTES = (2 + PL) * TILE_BYTES;  // cos, sin, frames
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t barriers[2 * STAGES];  // full, then empty, per stage
  // the swizzle pattern repeats every 1024 bytes of shared address
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t smem_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full =
      static_cast<uint32_t>(__cvta_generic_to_shared(barriers));
  const uint32_t empty = full + 8 * STAGES;

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BT, f0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  const int chunks = (N + BK - 1) / BK;
  // warpgroups with bins: one whose 64 bins all lie past F multiplies nothing
  const int groups = f0 + 64 < F ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // every loader arrives twice: behind its copies, and after its stores
      mbar_init(full + 8 * s, 2 * LOADERS);
      mbar_init(empty + 8 * s, 128 * groups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---- a loading warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Storage<S>::LOADER_REGS));
    const int tid = threadIdx.x - 256;
    const S* xt =
        x + static_cast<long long>(b) * L + static_cast<long long>(t0) * hop;
    const S* wc = wcos + static_cast<long long>(f0) * N;
    const S* ws = wsin + static_cast<long long>(f0) * N;
    // The bases go by TMA, or through registers where TMA cannot take them.
    // The frames go by asynchronous copies where they need no split and
    // their rows are 4-byte aligned (bf16), else through registers, chunk
    // c + 1 being read while chunk c is stored.
    const bool x_regs = sizeof(S) == 4 || vb_x < 4;
    uint32_t stg[TILE_CHUNKS][4];
    if (x_regs) load_tile<S, BT>(xt, hop, T - t0, N, 0, vb_x, tid, stg);
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES, k0 = c * BK;
      const uint32_t stage_addr = smem_addr + s * STAGE_BYTES;
      unsigned char* stage = smem + s * STAGE_BYTES;
      mbar_wait(empty + 8 * s, ((c / STAGES) & 1) ^ 1);
      if (use_tma && tid == 0) {
        mbar_expect_bytes(full + 8 * s, 2 * TILE_BYTES);
        tma_load_tile(&map_cos, k0, f0, stage_addr, full + 8 * s);
        tma_load_tile(&map_sin, k0, f0, stage_addr + TILE_BYTES, full + 8 * s);
      }
      if (!x_regs)
        copy_tile<S, BT>(xt, hop, T - t0, N, k0, vb_x, tid,
                         stage_addr + 2 * TILE_BYTES);
      mbar_arrive_after_copies(full + 8 * s);
      if (x_regs) store_tile<S, BT, true>(stage + 2 * TILE_BYTES, tid, stg);
      if (!use_tma) {
        load_tile<S, BM>(wc, N, F - f0, N, k0, vb_w, tid, stg);
        store_tile<S, BM, false>(stage, tid, stg);
        load_tile<S, BM>(ws, N, F - f0, N, k0, vb_w, tid, stg);
        store_tile<S, BM, false>(stage + TILE_BYTES, tid, stg);
      }
      if (x_regs && c + 1 < chunks)
        load_tile<S, BT>(xt, hop, T - t0, N, k0 + BK, vb_x, tid, stg);
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // ---- a multiplying warpgroup: bins [f0 + 64 wg, f0 + 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Storage<S>::MULTIPLIER_REGS));
  if (wg >= groups) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // the basis row whose address this lane gives `ldmatrix` (see load_a)
  const uint32_t lane_row = (64 * wg + 16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * ROW_BYTES;
  const uint32_t lane_swz = lane % 8, lane_h = lane / 16;
  float re[BT / 2], im[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) re[i] = im[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(full + 8 * s, (c / STAGES) & 1);
    // The frame tile was written through the generic proxy (copies or
    // stores) and is read by the tensor cores through the async proxy. The
    // fence stands here, behind the barrier, and not in the loader, where it
    // would wait for the copies in flight and undo the ring.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consume_stage<BT>(static_cast<const S*>(nullptr), smem_addr + s * STAGE_BYTES,
                      lane_row, lane_swz, lane_h, re, im);
    mbar_arrive(empty + 8 * s);
  }

  // Every chunk has been loaded and multiplied: the ring is free once the
  // other multiplying warpgroup, if it has bins, is through its last stage.
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * groups) : "memory");

  if (epilogue == FILTERBANK) {
    // park the power as the projection's B operand, then make the stores
    // visible to the tensor cores (async proxy) before either warpgroup
    // reads the other's bins
    park_power<BT>(static_cast<const S*>(nullptr), re, im, smem,
                   64 * wg + 16 * warp, lane, eps);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"r"(128 * groups) : "memory");
    const S* fbT = static_cast<const S*>(ep.fbT);
    float* work = ep.work + static_cast<long long>(blockIdx.y * gridDim.z + b) * ep.M * ep.Tp;
    for (int mt = wg; 64 * mt < ep.M; mt += groups) {
      const int m_row = 64 * mt + 16 * warp + lane / 4;
      float acc[BT / 2];
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
      project_power<BT>(fbT, smem_addr, F, ep.M, f0, m_row, lane, acc);
      // accumulator i holds mel m_row + 8*((i/2)%2), frame 8*(i/4) + 2*(lane%4) + i%2
#pragma unroll
      for (int i = 0; i < BT / 2; i += 2) {
        const int m = m_row + 8 * ((i / 2) % 2), t = t0 + 8 * (i / 4) + 2 * (lane % 4);
        if (m < ep.M && t < ep.Tp)
          *reinterpret_cast<float2*>(work + static_cast<long long>(m) * ep.Tp + t) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
    return;
  }

  // Accumulator i of lane l of warp w holds bin 16w + l/4 + 8*((i/2)%2),
  // frame 8*(i/4) + 2*(l%4) + i%2. A warp parks its 16 bins x BT frames in
  // shared memory (GL_STEP: re, then im 16 rows below) and walks them row by
  // row, so that a store instruction writes 32 consecutive frames of one bin.
  constexpr int PITCH = BT + 4;  // floats; keeps the float2 writes off one bank
  float* park = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 32 * PITCH;
  const int f_warp = f0 + 64 * wg + 16 * warp;
  const long long base = (static_cast<long long>(b) * F + f_warp) * T + t0;
  if (epilogue == GL_STEP) {
#pragma unroll
    for (int i = 0; i < BT / 2; i += 2) {
      const int row = lane / 4 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(park + row * PITCH + col) = make_float2(re[i], re[i + 1]);
      *reinterpret_cast<float2*>(park + (16 + row) * PITCH + col) =
          make_float2(im[i], im[i + 1]);
    }
    __syncwarp();
    if (ep.carry_bf16)
      gl_step_rows<__nv_bfloat16, BT>(park, ep, base, f_warp, F, T, t0, lane);
    else
      gl_step_rows<float, BT>(park, ep, base, f_warp, F, T, t0, lane);
    return;
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && epilogue != PAIR) break;
#pragma unroll
    for (int i = 0; i < BT / 2; i += 2) {
      float2 v;
      if (epilogue == PAIR) {
        v = pass ? make_float2(im[i], im[i + 1]) : make_float2(re[i], re[i + 1]);
      } else {
        v.x = re[i] * re[i] + im[i] * im[i] + eps;
        v.y = re[i + 1] * re[i + 1] + im[i + 1] * im[i + 1] + eps;
        if (epilogue == MAGNITUDE) v = make_float2(sqrtf(v.x), sqrtf(v.y));
      }
      const int row = lane / 4 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(park + row * PITCH + col) = v;
    }
    __syncwarp();
    float* out = pass ? out1 : out0;
    for (int row = 0; row < 16 && f_warp + row < F; ++row)
      for (int col = lane; col < BT && t0 + col < T; col += 32)
        out[base + static_cast<long long>(row) * T + col] = park[row * PITCH + col];
    __syncwarp();
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

template <typename S, int BT>
cudaError_t launch_bt(const void* x, const void* wcos, const void* wsin,
                      void* out0, void* out1, int B, int L, int N, int hop,
                      int F, int T, float eps, int epilogue,
                      const EpilogueArgs& ep, cudaStream_t st) {
  constexpr int SMEM =
      Storage<S>::STAGES * (2 + Storage<S>::PLANES) * TILE_BYTES + 1024;
  const uintptr_t es = sizeof(S);
  const int vb_w = piece_bytes(reinterpret_cast<uintptr_t>(wcos) |
                               reinterpret_cast<uintptr_t>(wsin) | (N * es));
  const int vb_x = piece_bytes(reinterpret_cast<uintptr_t>(x) | (L * es) |
                               (hop * es) | (N * es));
  // TMA serves the bases when their rows are 16-byte aligned; the loaders'
  // registers serve any other
  CUtensorMap map_cos{}, map_sin{};
  const int use_tma = vb_w == 16 && tile_map<S>(wcos, F, N, &map_cos) &&
                      tile_map<S>(wsin, F, N, &map_sin);
  cudaError_t err = cudaFuncSetAttribute(
      framed_tc_kernel<S, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BT - 1) / BT, (F + BM - 1) / BM, B);
  framed_tc_kernel<S, BT><<<grid, NT, SMEM, st>>>(
      static_cast<const S*>(x), static_cast<const S*>(wcos),
      static_cast<const S*>(wsin), static_cast<float*>(out0),
      static_cast<float*>(out1), L, N, hop, F, T, eps, epilogue, vb_w, vb_x,
      use_tma, ep, map_cos, map_sin);
  return cudaGetLastError();
}

// The frame-tile width that pads T least; the wider of two that tie. In
// fp32 storage the third accumulator leaves no registers for 128 frames.
template <typename S>
cudaError_t launch(const void* x, const void* wcos, const void* wsin,
                   void* out0, void* out1, int B, int L, int N, int hop, int F,
                   int T, float eps, int epilogue, const EpilogueArgs& ep,
                   cudaStream_t st) {
  auto padded = [T](int bt) { return (T + bt - 1) / bt * bt; };
  if constexpr (sizeof(S) == 2) {
    if (padded(128) <= padded(112) && padded(128) <= padded(64))
      return launch_bt<S, 128>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T,
                               eps, epilogue, ep, st);
  }
  if (padded(112) <= padded(64))
    return launch_bt<S, 112>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T,
                             eps, epilogue, ep, st);
  return launch_bt<S, 64>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T, eps,
                          epilogue, ep, st);
}

cudaError_t launch_storage(int bf16, const void* x, const void* wcos,
                           const void* wsin, void* out0, void* out1, int B,
                           int L, int N, int hop, int F, int T, float eps,
                           int epilogue, const EpilogueArgs& ep, cudaStream_t st) {
  if (bf16)
    return launch<__nv_bfloat16>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T,
                                 eps, epilogue, ep, st);
  return launch<float>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T, eps,
                       epilogue, ep, st);
}

}  // namespace

extern "C" int nnaudio_framed_magnitude(const void* x, const void* wcos,
                                        const void* wsin, void* out, int B,
                                        int L, int N, int hop, int F, int T,
                                        float eps, int square, int bf16,
                                        void* stream) {
  return launch_storage(bf16, x, wcos, wsin, out, nullptr, B, L, N, hop, F, T,
                        eps, square ? POWER : MAGNITUDE, EpilogueArgs{},
                        static_cast<cudaStream_t>(stream));
}

extern "C" int nnaudio_framed_pair(const void* x, const void* wcos,
                                   const void* wsin, void* re, void* im, int B,
                                   int L, int N, int hop, int F, int T,
                                   int bf16, void* stream) {
  return launch_storage(bf16, x, wcos, wsin, re, im, B, L, N, hop, F, T, 0.f,
                        PAIR, EpilogueArgs{}, static_cast<cudaStream_t>(stream));
}

// fbT is the (F, M) transpose of the filterbank in the storage type; work
// holds ceil(F/128) * B * M * Tp floats, Tp = T rounded up to a multiple of 8.
extern "C" int nnaudio_framed_filterbank(const void* x, const void* wcos,
                                         const void* wsin, const void* fbT,
                                         void* out, void* work, int B, int L,
                                         int N, int hop, int F, int T, int M,
                                         float eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EpilogueArgs ep{};
  ep.fbT = fbT;
  ep.work = static_cast<float*>(work);
  ep.M = M;
  ep.Tp = (T + 7) / 8 * 8;
  cudaError_t err = launch_storage(bf16, x, wcos, wsin, nullptr, nullptr, B, L,
                                   N, hop, F, T, eps, FILTERBANK, ep, st);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * M, n = rows * T;
  const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  filterbank_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(out), (F + BM - 1) / BM,
      rows, T, ep.Tp);
  return cudaGetLastError();
}

// S (mag) is fp32; p_re, p_im and the four outputs are fp32, or bf16 with
// carry_bf16
extern "C" int nnaudio_gl_step(const void* x, const void* wcos,
                               const void* wsin, const void* mag,
                               const void* p_re, const void* p_im, void* c_re,
                               void* c_im, void* r_re, void* r_im, int B,
                               int L, int N, int hop, int F, int T, float mom,
                               int bf16, int carry_bf16, void* stream) {
  EpilogueArgs ep{};
  ep.mag = static_cast<const float*>(mag);
  ep.p_re = p_re;
  ep.p_im = p_im;
  ep.c_re = c_re;
  ep.c_im = c_im;
  ep.r_re = r_re;
  ep.r_im = r_im;
  ep.mom = mom;
  ep.carry_bf16 = carry_bf16;
  return launch_storage(bf16, x, wcos, wsin, nullptr, nullptr, B, L, N, hop, F,
                        T, 0.f, GL_STEP, ep, static_cast<cudaStream_t>(stream));
}
