// Framed analysis on Hopper's tensor cores (sm_90a): the STFT magnitude /
// power (K1) and the plain re/im pair (K5) on one `wgmma` main loop.
//
// Replaces nnaudio_tpu/ops/framed_matmul.py:
//   K1  _magnitude_kernel :273  (launched by _framed_analysis, pair=False)
//   K5  _pair_kernel      :205  (launched by _framed_analysis, pair=True)
//
// For the cos and sin bases (F, N) and a signal x (B, L), any hop >= 1,
//   re[b,f,t] = sum_k x[b, t*hop + k] * wcos[f,k]
//   im[b,f,t] = sum_k x[b, t*hop + k] * wsin[f,k]
// K5 stores (re, im) as two (B, F, T) fp32 arrays; K1 stores
// sqrt(re^2 + im^2 + eps), or the power when `square`.
//
// Per batch item this is a GEMM D (F x T) = W (F x N) * X^T, where the frame
// matrix X[t,k] = x[t*hop + k] is a strided, overlapping view of the signal
// that never exists in device memory. Both operands are K-major, which is
// what `wgmma` wants of a shared-memory operand in TF32.
//
// What bounds it on the H100 (4*B*T*F*N flops; 115.8 GFLOP at B=32, T=431,
// F=1025, N=2048 over ~102 MB (K1) or ~158 MB (K5) of compulsory traffic):
// operations. The tensor-core peaks are 495 TFLOP/s in TF32 and 989 in bf16,
// so the floor is 0.234 ms for one TF32 product, 0.70 ms for the three
// products that keep fp32 accuracy, and 0.117 ms in bf16. A 128 x 112 tile
// reads 368 operand rows of 128 bytes per K chunk: 3.5 GB through L2 at that
// shape in fp32 and 1.7 GB in bf16, where moving them takes longer than the
// products do.
//
// Design:
// - A block owns 128 bins x BT frames of one batch item (BT = 128, 112 or 64,
//   chosen per launch so that the frame tiles waste least of T; 128 only in
//   bf16). It runs four warpgroups: two multiply, two load.
// - Multiplying warpgroup w takes bins [64w, 64w+64) of the cos and of the sin
//   tile against the one shared frame tile: `wgmma` m64nBTk8 (TF32) or
//   m64nBTk16 (bf16) with A (the basis) from registers and B (the frames)
//   from shared memory, fp32 accumulators in registers, BT/2 each for re and
//   im, which land in the same thread, so both epilogues stay in registers.
//   A warpgroup whose 64 bins all lie past F leaves at once.
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
//   j ^ (r % 8)); the basis tiles use the same pattern so that a thread's
//   reads of its A registers hit 32 banks.
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
// - The epilogue parks each warp's 16 bins x BT frames in the ring, once it
//   is free, and stores them row by row: 32 consecutive frames a store.
// - Deterministic: fixed summation order, no atomics, no library call.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode).
// Launchers return cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 512;               // two multiplying warpgroups, then two loading ones
constexpr int LOADERS = 256;          // threads of the loading warpgroups
// registers per thread after `setmaxnreg`: 256 * 208 + 256 * 48 = 65,536,
// the 512 * 128 that the block is launched with
constexpr int MULTIPLIER_REGS = 208;
constexpr int LOADER_REGS = 48;
constexpr int BM = 128;               // bins per block, 64 per warpgroup
constexpr int ROW_BYTES = 128;        // one tile row = one swizzle span of K
constexpr int TILE_BYTES = BM * ROW_BYTES;  // 16 KB; frame tiles have <= 128 rows
constexpr int TILE_CHUNKS = 4;        // 16-byte chunks of one tile a loader thread moves

enum Epilogue { PAIR = 0, MAGNITUDE = 1, POWER = 2 };

// A stage holds the cos and the sin tile as they are in memory and the frame
// tile in PLANES planes (fp32: hi and lo).
template <typename S> struct Storage;
template <> struct Storage<float> {
  static constexpr int PLANES = 2;
  static constexpr int BK = 32;       // samples of K per 128-byte row
  static constexpr int STAGES = 3;    // 64 KB each
};
template <> struct Storage<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;    // 48 KB each
};

// ------------------------------------------------------------------ wgmma --
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching registers that products in flight still
// read or write
template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_registers(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart. A K step of 32 bytes inside the row is
// taken by adding 2 (32 >> 4) to the descriptor's address field.
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define NN_D8(o)                                                              \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define NN_D32 NN_D8(0), NN_D8(8), NN_D8(16), NN_D8(24)
#define NN_D56 NN_D32, NN_D8(32), NN_D8(40), NN_D8(48)
#define NN_D64 NN_D56, NN_D8(56)
#define NN_R32                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define NN_R56                                                               \
  NN_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
         "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
#define NN_R64 NN_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x BT, fp32, registers) = A (64 x k, registers) * B (BT x k, shared)^T
// + (scale_d ? D : 0). A thread's four A registers hold rows g and g + 8 of
// its warp's 16 rows (g = lane / 4) at the 4-byte words lane % 4 and
// lane % 4 + 4 of the 32-byte K step: (g, w), (g + 8, w), (g, w + 4),
// (g + 8, w + 4), in TF32 and in bf16 pairs alike.
template <typename S, int BT> struct Mma;
#define NN_MMA(S, BT, SHAPE_TYPES, REGS, OPERANDS, A, B, P, TAIL)             \
  template <> struct Mma<S, BT> {                                             \
    static __device__ __forceinline__ void run(float (&d)[BT / 2],            \
                                               const uint32_t (&a)[4],        \
                                               uint64_t b, int scale_d) {     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"              \
                   "wgmma.mma_async.sync.aligned." SHAPE_TYPES " {" REGS "}, " \
                   A ", " B ", p, " TAIL ";\n}\n"                              \
                   : OPERANDS                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                     "r"(scale_d));                                           \
    }                                                                         \
  };
NN_MMA(float, 64, "m64n64k8.f32.tf32.tf32", NN_R32, NN_D32, "{%32, %33, %34, %35}", "%36", "%37", "1, 1")
NN_MMA(float, 112, "m64n112k8.f32.tf32.tf32", NN_R56, NN_D56, "{%56, %57, %58, %59}", "%60", "%61", "1, 1")
NN_MMA(__nv_bfloat16, 64, "m64n64k16.f32.bf16.bf16", NN_R32, NN_D32, "{%32, %33, %34, %35}", "%36", "%37", "1, 1, 0")
NN_MMA(__nv_bfloat16, 112, "m64n112k16.f32.bf16.bf16", NN_R56, NN_D56, "{%56, %57, %58, %59}", "%60", "%61", "1, 1, 0")
NN_MMA(__nv_bfloat16, 128, "m64n128k16.f32.bf16.bf16", NN_R64, NN_D64, "{%64, %65, %66, %67}", "%68", "%69", "1, 1, 0")
#undef NN_MMA

// ----------------------------------------------------------------- loader --
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

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

// ---------------------------------------------------------------- barriers --
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrives once this thread's asynchronous copies so far have landed; the
// barrier's count includes this arrival
__device__ __forceinline__ void mbar_arrive_after_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// adds `bytes` to what the barrier's phase waits for, without arriving
__device__ __forceinline__ void mbar_expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// One TMA load of the box of `map` at (column k, row f) into a tile; the
// bytes count on the barrier. Rows and columns outside the tensor are zero.
__device__ __forceinline__ void tma_load_tile(const CUtensorMap* map, int k, int f,
                                              uint32_t tile_addr, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(tile_addr),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(f)
      : "memory");
}
// returns once the barrier has left the phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------- products --
// A thread's A registers of the four K steps of one chunk, read from a basis
// tile as it was copied (16-byte chunk j of row r at chunk j ^ (r % 8)).
// `row_addr` is the shared address of the thread's row g, `swz` = (g % 8) << 4,
// `word` = 4 * (lane % 4).
__device__ __forceinline__ void load_a(uint32_t row_addr, uint32_t swz,
                                       uint32_t word, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = row_addr + ((((2 * ks + h) << 4) ^ swz) | word);
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[ks][2 * h]) : "r"(at));
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(a[ks][2 * h + 1])
                   : "r"(at + 8 * ROW_BYTES));
    }
}

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
                                              uint32_t row_off, uint32_t swz,
                                              uint32_t word, float (&re)[BT / 2],
                                              float (&im)[BT / 2]) {
  const uint64_t x_hi = tile_descriptor(stage + 2 * TILE_BYTES);
  const uint64_t x_lo = tile_descriptor(stage + 3 * TILE_BYTES);
  float part[BT / 2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int basis = 0; basis < 2; ++basis) {
    load_a(stage + basis * TILE_BYTES + row_off, swz, word, hi);
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
                                              uint32_t row_off, uint32_t swz,
                                              uint32_t word, float (&re)[BT / 2],
                                              float (&im)[BT / 2]) {
  const uint64_t x = tile_descriptor(stage + 2 * TILE_BYTES);
  uint32_t c[4][4], s[4][4];
  load_a(stage + row_off, swz, word, c);
  load_a(stage + TILE_BYTES + row_off, swz, word, s);
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

// grid (ceil(T/BT), ceil(F/128), B); threads: two multiplying warpgroups,
// then two loading ones
template <typename S, int BT>
__global__ void __launch_bounds__(NT, 1) framed_tc_kernel(
    const S* __restrict__ x, const S* __restrict__ wcos,
    const S* __restrict__ wsin, float* __restrict__ out0,
    float* __restrict__ out1, int L, int N, int hop, int F, int T, float eps,
    int epilogue, int vb_w, int vb_x, int use_tma,
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

  if (threadIdx.x == 0) {
    // a warpgroup whose 64 bins all lie past F multiplies nothing
    const int multipliers = f0 + 64 < F ? 256 : 128;
    for (int s = 0; s < STAGES; ++s) {
      // every loader arrives twice: behind its copies, and after its stores
      mbar_init(full + 8 * s, 2 * LOADERS);
      mbar_init(empty + 8 * s, multipliers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---- a loading warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MULTIPLIER_REGS));
  if (f0 + 64 * wg >= F) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const uint32_t row_off = (64 * wg + 16 * warp + lane / 4) * ROW_BYTES;
  const uint32_t swz = ((lane / 4) & 7) << 4, word = 4 * (lane % 4);
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
                      row_off, swz, word, re, im);
    mbar_arrive(empty + 8 * s);
  }

  // Every chunk has been loaded and multiplied: the ring is free once the
  // other multiplying warpgroup, if it has bins, is through its last stage.
  asm volatile("bar.sync 1, %0;\n" ::"r"(f0 + 64 < F ? 256 : 128) : "memory");

  // Accumulator i of lane l of warp w holds bin 16w + l/4 + 8*((i/2)%2),
  // frame 8*(i/4) + 2*(l%4) + i%2. A warp parks its 16 bins x BT frames in
  // shared memory and stores them row by row, so that a store instruction
  // writes 32 consecutive frames of one bin.
  constexpr int PITCH = BT + 4;  // floats; keeps the float2 writes off one bank
  float* park = reinterpret_cast<float*>(smem) + (threadIdx.x / 32) * 16 * PITCH;
  const int f_warp = f0 + 64 * wg + 16 * warp;
  const long long base = (static_cast<long long>(b) * F + f_warp) * T + t0;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, resolved at run time: nothing links against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a basis (F, N): boxes of 128 rows x 128 bytes, laid down
// in the 128-byte swizzle, zeros outside the tensor.
template <typename S>
bool basis_map(const void* w, int F, int N, CUtensorMap* map) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(F)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * sizeof(S)};
  const cuuint32_t box[2] = {Storage<S>::BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map,
                sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename S, int BT>
cudaError_t launch_bt(const void* x, const void* wcos, const void* wsin,
                      void* out0, void* out1, int B, int L, int N, int hop,
                      int F, int T, float eps, int epilogue, cudaStream_t st) {
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
  const int use_tma = vb_w == 16 && basis_map<S>(wcos, F, N, &map_cos) &&
                      basis_map<S>(wsin, F, N, &map_sin);
  cudaError_t err = cudaFuncSetAttribute(
      framed_tc_kernel<S, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BT - 1) / BT, (F + BM - 1) / BM, B);
  framed_tc_kernel<S, BT><<<grid, NT, SMEM, st>>>(
      static_cast<const S*>(x), static_cast<const S*>(wcos),
      static_cast<const S*>(wsin), static_cast<float*>(out0),
      static_cast<float*>(out1), L, N, hop, F, T, eps, epilogue, vb_w, vb_x,
      use_tma, map_cos, map_sin);
  return cudaGetLastError();
}

// The frame-tile width that pads T least; the wider of two that tie. In
// fp32 storage the third accumulator leaves no registers for 128 frames.
template <typename S>
cudaError_t launch(const void* x, const void* wcos, const void* wsin,
                   void* out0, void* out1, int B, int L, int N, int hop, int F,
                   int T, float eps, int epilogue, cudaStream_t st) {
  auto padded = [T](int bt) { return (T + bt - 1) / bt * bt; };
  if constexpr (sizeof(S) == 2) {
    if (padded(128) <= padded(112) && padded(128) <= padded(64))
      return launch_bt<S, 128>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T, eps, epilogue, st);
  }
  if (padded(112) <= padded(64))
    return launch_bt<S, 112>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T, eps, epilogue, st);
  return launch_bt<S, 64>(x, wcos, wsin, out0, out1, B, L, N, hop, F, T, eps, epilogue, st);
}

}  // namespace

extern "C" int nnaudio_framed_magnitude(const void* x, const void* wcos,
                                        const void* wsin, void* out, int B,
                                        int L, int N, int hop, int F, int T,
                                        float eps, int square, int bf16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epilogue = square ? POWER : MAGNITUDE;
  if (bf16)
    return launch<__nv_bfloat16>(x, wcos, wsin, out, nullptr, B, L, N, hop, F,
                                 T, eps, epilogue, st);
  return launch<float>(x, wcos, wsin, out, nullptr, B, L, N, hop, F, T, eps,
                       epilogue, st);
}

extern "C" int nnaudio_framed_pair(const void* x, const void* wcos,
                                   const void* wsin, void* re, void* im, int B,
                                   int L, int N, int hop, int F, int T,
                                   int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, wcos, wsin, re, im, B, L, N, hop, F, T,
                                 0.f, PAIR, st);
  return launch<float>(x, wcos, wsin, re, im, B, L, N, hop, F, T, 0.f, PAIR, st);
}
