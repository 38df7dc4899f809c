// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// framed_tc.cu (K1, K2, K4, K5), synthesis_ola.cu (K3) and framed_kchunk.cu
// (K6): `wgmma` with A from registers and B from shared memory in the
// 128-byte swizzle, the `ldmatrix` read of A, the TF32 rounding of the
// 3xTF32 split, `mbarrier`s, and TMA loads of 128-row boxes through tensor
// maps encoded at run time.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ROW_BYTES = 128;              // one tile row = one swizzle span of K
constexpr int TILE_BYTES = 128 * ROW_BYTES;  // 16 KB: a tile has <= 128 rows

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
#define NN_D16 NN_D8(0), NN_D8(8)
#define NN_D32 NN_D16, NN_D8(16), NN_D8(24)
#define NN_D56 NN_D32, NN_D8(32), NN_D8(40), NN_D8(48)
#define NN_D64 NN_D56, NN_D8(56)
#define NN_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define NN_R16 NN_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define NN_R32                                                                 \
  NN_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
         "%29, %30, %31"
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
NN_MMA(float, 16, "m64n16k8.f32.tf32.tf32", NN_R8, NN_D8(0), "{%8, %9, %10, %11}", "%12", "%13", "1, 1")
NN_MMA(float, 32, "m64n32k8.f32.tf32.tf32", NN_R16, NN_D16, "{%16, %17, %18, %19}", "%20", "%21", "1, 1")
NN_MMA(float, 64, "m64n64k8.f32.tf32.tf32", NN_R32, NN_D32, "{%32, %33, %34, %35}", "%36", "%37", "1, 1")
NN_MMA(float, 112, "m64n112k8.f32.tf32.tf32", NN_R56, NN_D56, "{%56, %57, %58, %59}", "%60", "%61", "1, 1")
NN_MMA(float, 128, "m64n128k8.f32.tf32.tf32", NN_R64, NN_D64, "{%64, %65, %66, %67}", "%68", "%69", "1, 1")
NN_MMA(__nv_bfloat16, 16, "m64n16k16.f32.bf16.bf16", NN_R8, NN_D8(0), "{%8, %9, %10, %11}", "%12", "%13", "1, 1, 0")
NN_MMA(__nv_bfloat16, 32, "m64n32k16.f32.bf16.bf16", NN_R16, NN_D16, "{%16, %17, %18, %19}", "%20", "%21", "1, 1, 0")
NN_MMA(__nv_bfloat16, 64, "m64n64k16.f32.bf16.bf16", NN_R32, NN_D32, "{%32, %33, %34, %35}", "%36", "%37", "1, 1, 0")
NN_MMA(__nv_bfloat16, 112, "m64n112k16.f32.bf16.bf16", NN_R56, NN_D56, "{%56, %57, %58, %59}", "%60", "%61", "1, 1, 0")
NN_MMA(__nv_bfloat16, 128, "m64n128k16.f32.bf16.bf16", NN_R64, NN_D64, "{%64, %65, %66, %67}", "%68", "%69", "1, 1, 0")
#undef NN_MMA

// ------------------------------------------------------------------ split --
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
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

// ----------------------------------------------------------------- A operand --
// A thread's A registers of the four K steps of one chunk, read from a basis
// tile as it was copied (16-byte chunk j of row r at chunk j ^ (r % 8)) by
// `ldmatrix`: per K step four 8-row matrices of 16 bytes, rows 0-7 and 8-15
// of the warp's 16 at chunks 2 ks and 2 ks + 1. Lane l gives the address of
// row l % 8 + 8 ((l / 8) % 2) at chunk 2 ks + l / 16 (`lane_row` is that
// row's shared address, `lane_swz` = l % 8, `lane_h` = l / 16) and receives
// word l % 4 of row l / 4 of each: the layout `wgmma` wants of A. Four
// addresses a chunk where reads of single words took eight, which held
// eight registers through the products and were spilled (fp32, BT = 112).
__device__ __forceinline__ void load_a(uint32_t lane_row, uint32_t lane_swz,
                                       uint32_t lane_h, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t at = lane_row + (((2 * ks + lane_h) ^ lane_swz) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[ks][0]), "=r"(a[ks][1]), "=r"(a[ks][2]), "=r"(a[ks][3])
                 : "r"(at));
  }
}

// ------------------------------------------------------------------- TMA --
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

// A tensor map over a row-major (rows, cols) matrix of S: boxes of 128 rows
// x 128 bytes, laid down in the 128-byte swizzle, zeros outside the matrix.
// TMA takes rows whose byte stride is a multiple of 16.
template <typename S>
bool tile_map(const void* w, int rows, int cols, CUtensorMap* map) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(S)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW_BYTES / sizeof(S)), 128};
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

}  // namespace
