// Synthesis + overlap-add on Hopper's tensor cores (sm_90a): the iSTFT hot
// path (K3).
//
// Replaces nnaudio_tpu/ops/framed_matmul.py _synthesis_ola_kernel (launched
// by _synthesis_ola). Computes, for spectra Re/Im (B, F, T) and kernels
// kc/ks (F, N) that already carry window, 1/N and Hermitian fold weights,
//   y[b, t*hop + j] += sum_f kc[f,j] * Re[b,f,t] - ks[f,j] * Im[b,f,t]
// into y (B, N + hop*(T-1)), with no window normalisation.
//
// Output-stationary. View y as rows of `hop` samples, y[r*hop + p]. Frame t
// reaches row r through its chunk c = r - t (j = c*hop + p < N), so
//   y[r*hop + p] = sum_c sum_f kc[f, c*hop + p] * Re[f, r-c] - ks[...] * Im[...]
// and a block's tile of y, 128 columns p x BT rows r of one batch item, is
// one GEMM D = A * B^T whose K loop runs over (chunk c, 32- or 64-bin chunk
// of F, Re then -Im): A[p, f] = kc[f, c*hop + p] (or ks), B[r, f] =
// Re[f, r - c] (or -Im). The overlap-add is part of the K loop: each sample
// is written once, by one block, in a fixed order: no atomics, no second
// pass, and a second launch gives the same bits. Any hop >= 1 works.
//
// Bound on the H100: 4*B*T*F*N flops against (2*B*F*T + 2*F*N) * sizeof(S)
// + B*len*4 bytes. At (b) (B=32, T=431, F=1025, N=2048, hop 512) that is
// 115.8 GFLOP over ~141 MB: operations, 0.234 ms for one TF32 product and
// 0.117 ms in bf16 (the same products as the pair, K5).
//
// Design, from framed_tc.cu's main loop (tc_common.cuh):
// - Two multiplying warpgroups (64 columns p each, `wgmma` m64nBTk8 TF32 or
//   m64nBTk16 bf16, A from registers, B from shared memory in the 128-byte
//   swizzle, fp32 accumulators in registers) and two loading ones, on a ring
//   of `mbarrier` stages in dynamic shared memory.
// - A is the kernels transposed, kcT / ksT (N, Fp), Fp = F rounded up to a K
//   chunk with zeros past F, made by the wrapper: TF32 `wgmma` takes only a
//   K-major A (the transpose bits are for 16-bit types), and TMA only rows
//   16-byte aligned. One TMA box of 128 rows x 128 bytes per stage, rows
//   c*hop + p0 ..., rows past N zero-filled; rows with p >= hop read the next
//   chunk's samples and feed only columns that are never stored. `ldmatrix`
//   reads A into the registers where fp32 is split.
// - B is the spectra, T-contiguous: MN-major for K = f. The loading threads
//   copy a step's bins x frames as they lie, in 16-byte pieces (`cp.async`,
//   consecutive pieces of one bin per warp instruction), into a ring of raw
//   slots three steps ahead, then write each row r's 16-byte chunk of 4
//   (fp32) or 8 (bf16) bins transposed into the K-major swizzled tile,
//   splitting fp32 into hi and lo planes and negating -Im on the way. Frames
//   r - c outside [0, T) and bins past F are zeros. The loads, not the
//   products, set the pace at (b) (tools/synthesis_ab.py times the kernel
//   without each part), so they run three steps ahead and move 16 bytes a
//   copy.
// - Precision by storage type, as in framed_tc.cu: fp32 storage takes
//   3xTF32, each stage's lo*hi, hi*lo, hi*hi summed in the tensor cores and
//   added to the running sum on the CUDA cores (`wgmma` truncates its fp32
//   sum, and K runs to n_chunks * 2F = 8200 at (b)); bf16 storage one bf16
//   product, summed in `wgmma`. A row's fp32 running sum takes 2 x n_chunks
//   x Fp/32 steps: up to KAHAN_MIN_STEPS a plain sum matches the plain
//   version's accuracy (264 at (b)); past it the launcher picks a build
//   that adds each step by a compensated sum (a plain sum of 1876 steps at
//   hop 3 lost 3-5x the plain version's accuracy, and the compensation
//   costs 9-14% at (b)'s and the pyramid dual bank's shapes).
// - A block skips the chunks c whose frames miss its rows or whose first
//   kernel sample lies past N, and a warpgroup whose 64 columns all lie at
//   or past hop multiplies nothing. The epilogue stores p < hop and
//   r*hop + p < len only.
//
// Storage type S is float (highest, tensorfloat32) or bf16 (default mode).
// The launcher returns cudaError_t.

#include "tc_common.cuh"

namespace {

constexpr int NT = 512;       // two multiplying warpgroups, then two loading ones
constexpr int LOADERS = 256;  // threads of the loading warpgroups
constexpr int BP = 128;       // columns p of a row per block, 64 per warpgroup

// A stage holds the A tile (16 KB) and the B tile in PLANES planes (fp32: hi
// and lo); behind the stages lie the four raw slots of the spectra (below),
// up to 17 KB each: at most 210 KB in all in fp32, 196 KB in bf16. Registers
// per thread after `setmaxnreg`, multiplying + loading warpgroups, as
// framed_tc.cu set them per storage type: 256 * (216 + 40) = 256 * (208 + 48)
// = 65,536.
template <typename S> struct Synth;
template <> struct Synth<float> {
  static constexpr int PLANES = 2;
  static constexpr int BK = 32;       // bins of F per 128-byte row
  static constexpr int STAGES = 3;    // 48 KB each
  static constexpr int MULTIPLIER_REGS = 216;
  static constexpr int LOADER_REGS = 40;
};
template <> struct Synth<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;    // 32 KB each
  static constexpr int MULTIPLIER_REGS = 208;
  static constexpr int LOADER_REGS = 48;
};

// The K loop of a block: step i is chunk c = c0 + i / (2 * kchunks), bins
// [f0, f0 + BK) with f0 = BK * ((i / 2) % kchunks), and Re (even i) or -Im.
struct Step {
  int c, f0, im;
};
__device__ __forceinline__ Step step_of(int i, int c0, int kchunks, int bk) {
  const int per_c = 2 * kchunks;
  return Step{c0 + i / per_c, bk * ((i % per_c) / 2), i & 1};
}

// The spectra of a step go global -> a raw slot of shared memory by
// asynchronous copies, AHEAD steps before they are used, then shared ->
// the step's B tile, transposed (and split) by the loading threads: a slot
// is [BK bins][PITCH frames], as the spectra lie in memory.
constexpr int AHEAD = 3;
constexpr int RAW_SLOTS = AHEAD + 1;
// Frames of a raw row: the copies move 16-byte pieces from the piece at or
// below the step's first frame, so a row holds one piece more than BT
// frames, and its first frame lies `shift` = t0 % EPP frames in.
template <typename S>
__host__ __device__ constexpr int frames_per_piece() { return 16 / static_cast<int>(sizeof(S)); }
template <typename S, int BT>
__host__ __device__ constexpr int raw_pitch() { return BT + frames_per_piece<S>(); }
template <typename S, int BT>
__host__ __device__ constexpr int raw_bytes() {
  return (Synth<S>::BK * raw_pitch<S, BT>() * static_cast<int>(sizeof(S)) + 127) / 128 * 128;
}

// The raw slot of a step: bins f0 .. f0 + BK of frames t0 - shift .. of one
// batch item's spectrum, zeros for pieces outside [0, Tp) and bins past F,
// by 16-byte copies. The wrapper pads the rows to Tp frames, a multiple of a
// piece, with zeros, so a piece lies wholly inside a row or outside it.
// Consecutive threads copy consecutive pieces of one bin.
template <typename S, int BT>
__device__ __forceinline__ void copy_spectra(const S* __restrict__ spec, int F, int Tp,
                                             int f0, int t0, int tid, uint32_t slot) {
  constexpr int BK = Synth<S>::BK, EPP = frames_per_piece<S>();
  constexpr int PITCH = raw_pitch<S, BT>(), PIECES = PITCH / EPP;
  const int ts = t0 - (((t0 % EPP) + EPP) % EPP);  // the piece at or below t0
#pragma unroll 2
  for (int e = tid; e < BK * PIECES; e += LOADERS) {
    const int fl = e / PIECES, q = e % PIECES, f = f0 + fl, t = ts + EPP * q;
    const bool ok = f < F && t >= 0 && t < Tp;
    const S* src = ok ? spec + static_cast<long long>(f) * Tp + t : spec;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     slot + static_cast<uint32_t>(sizeof(S)) * (fl * PITCH + EPP * q)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// A raw slot -> the B tile of a stage, -Im negated: unit u of 8 * BT is row
// r = u % BT and 16-byte chunk j = u / BT of the row, 4 (fp32) or 8 (bf16)
// bins, stored at chunk j ^ (r % 8); fp32 split into a hi plane and,
// TILE_BYTES behind it, a lo plane. Consecutive threads read consecutive
// frames of one bin, and eight consecutive rows fill all 32 banks.
template <typename S, int BT>
__device__ __forceinline__ void transpose_spectra(const unsigned char* slot,
                                                  unsigned char* tile, int shift,
                                                  bool negate, int tid) {
  constexpr int PITCH = raw_pitch<S, BT>();
#pragma unroll 2
  for (int u = tid; u < 8 * BT; u += LOADERS) {
    const int j = u / BT, r = u % BT;
    unsigned char* at = tile + r * ROW_BYTES + ((j ^ (r & 7)) << 4);
    if constexpr (sizeof(S) == 4) {
      const float* raw = reinterpret_cast<const float*>(slot) + 4 * j * PITCH + r + shift;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = negate ? -raw[e * PITCH] : raw[e * PITCH];
        hi[e] = tf32_rna(v);
        lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
      }
      *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(at + TILE_BYTES) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      const unsigned short* raw =
          reinterpret_cast<const unsigned short*>(slot) + 8 * j * PITCH + r + shift;
      const uint32_t sign = negate ? 0x80008000u : 0u;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (raw[2 * e * PITCH] | (static_cast<uint32_t>(raw[(2 * e + 1) * PITCH]) << 16)) ^ sign;
      *reinterpret_cast<uint4*>(at) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Steps of a row's running sum past which fp32 storage takes the
// compensated sum (ops/framed_kernels.py SYNTH_KAHAN_MIN_STEPS repeats it).
constexpr int KAHAN_MIN_STEPS = 512;

// One step of one warpgroup: acc += A (64 columns x BK bins) * B^T.
// fp32, 3xTF32: A split in registers, B by the loader; lo*hi, hi*lo, then
// hi*hi summed in the tensor cores into `part`, then added to acc on the
// CUDA cores. Plain: `part` is summed from zero. KAHAN: a compensated sum;
// `part` enters holding minus the rounding error of the previous add and
// leaves holding this add's, so the compensation costs no register and a
// long running sum (1876 steps at N = 400, hop 3, F = 201) keeps fp32
// accuracy, as the plain version's does.
template <int BT, bool KAHAN>
__device__ __forceinline__ void consume_step(const float*, uint32_t stage,
                                             uint32_t lane_row, uint32_t lane_swz,
                                             uint32_t lane_h, float (&acc)[BT / 2],
                                             float (&part)[BT / 2]) {
  const uint64_t x_hi = tile_descriptor(stage + TILE_BYTES);
  const uint64_t x_lo = tile_descriptor(stage + 2 * TILE_BYTES);
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
  fence_registers(part);
  fence_registers(hi);
  fence_registers(lo);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, lo[ks], x_hi + 2 * ks, KAHAN || ks > 0);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, hi[ks], x_lo + 2 * ks, 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) Mma<float, BT>::run(part, hi[ks], x_hi + 2 * ks, 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(part);
  fence_registers(hi);
  fence_registers(lo);
  if constexpr (KAHAN) {
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const float y = part[i];
      const float t = acc[i] + y;
      part[i] = y - (t - acc[i]);
      acc[i] = t;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] += part[i];
  }
}
// bf16: one product, summed in `wgmma`.
template <int BT, bool KAHAN>
__device__ __forceinline__ void consume_step(const __nv_bfloat16*, uint32_t stage,
                                             uint32_t lane_row, uint32_t lane_swz,
                                             uint32_t lane_h, float (&acc)[BT / 2],
                                             float (&)[BT / 2]) {
  const uint64_t x = tile_descriptor(stage + TILE_BYTES);
  uint32_t a[4][4];
  load_a(stage + lane_row, lane_swz, lane_h, a);
  fence_registers(acc);
  fence_registers(a);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) Mma<__nv_bfloat16, BT>::run(acc, a[ks], x + 2 * ks, 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(acc);
  fence_registers(a);
}

// grid (ceil(R/BT), ceil(hop/128), B), R = T + n_chunks - 1 rows; threads:
// two multiplying warpgroups, then two loading ones
template <typename S, int BT, bool KAHAN>
__global__ void __launch_bounds__(NT, 1) synthesis_tc_kernel(
    const S* __restrict__ sre, const S* __restrict__ sim, float* __restrict__ y,
    int F, int T, int Tp, int N, int hop, int Fp, int length,
    const __grid_constant__ CUtensorMap map_kc,
    const __grid_constant__ CUtensorMap map_ks) {
  constexpr int BK = Synth<S>::BK;
  constexpr int STAGES = Synth<S>::STAGES;
  constexpr int STAGE_BYTES = (1 + Synth<S>::PLANES) * TILE_BYTES;  // A, then B
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t barriers[2 * STAGES];  // full, then empty, per stage
  // the swizzle pattern repeats every 1024 bytes of shared address
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(barriers));
  const uint32_t empty = full + 8 * STAGES;

  const int b = blockIdx.z;
  const int r0 = blockIdx.x * BT, p0 = blockIdx.y * BP;
  const int wg = threadIdx.x / 128;
  // the chunks whose frames r - c touch rows [r0, r0 + BT) and whose first
  // kernel sample c*hop + p0 lies inside the frame
  const int n_chunks = (N + hop - 1) / hop;
  const int c0 = max(0, r0 - (T - 1));
  const int c1 = min(min(n_chunks - 1, r0 + BT - 1), p0 < N ? (N - 1 - p0) / hop : -1);
  const int kchunks = Fp / BK;
  const int steps = c1 >= c0 ? (c1 - c0 + 1) * 2 * kchunks : 0;
  // warpgroups with columns: one whose 64 columns all lie at or past hop
  // multiplies nothing
  const int groups = p0 + 64 < hop ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, LOADERS);  // every loader arrives after its stores
      mbar_init(empty + 8 * s, 128 * groups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---- a loading warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Synth<S>::LOADER_REGS));
    const int tid = threadIdx.x - 256;
    const long long item = static_cast<long long>(b) * F * Tp;
    const uint32_t raw_addr = smem_addr + STAGES * STAGE_BYTES;
    auto copy = [&](int i) {
      if (i < steps) {
        const Step st = step_of(i, c0, kchunks, BK);
        copy_spectra<S, BT>((st.im ? sim : sre) + item, F, Tp, st.f0, r0 - st.c, tid,
                            raw_addr + (i % RAW_SLOTS) * raw_bytes<S, BT>());
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int i = 0; i < AHEAD; ++i) copy(i);
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES;
      const Step st = step_of(i, c0, kchunks, BK);
      // this thread's copies of step i have landed; the barrier makes every
      // loader's visible, and ends every loader's reads of step i - 1's slot
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(LOADERS) : "memory");
      mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_bytes(full + 8 * s, TILE_BYTES);
        tma_load_tile(st.im ? &map_ks : &map_kc, st.f0, st.c * hop + p0,
                      smem_addr + s * STAGE_BYTES, full + 8 * s);
      }
      constexpr int EPP = frames_per_piece<S>();
      transpose_spectra<S, BT>(smem + STAGES * STAGE_BYTES + (i % RAW_SLOTS) * raw_bytes<S, BT>(),
                               smem + s * STAGE_BYTES + TILE_BYTES,
                               (((r0 - st.c) % EPP) + EPP) % EPP, st.im, tid);
      mbar_arrive(full + 8 * s);
      copy(i + AHEAD);  // into the slot of step i - 1
    }
    return;
  }

  // ---- a multiplying warpgroup: columns [p0 + 64 wg, p0 + 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Synth<S>::MULTIPLIER_REGS));
  if (wg >= groups) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // the A row whose address this lane gives `ldmatrix` (see load_a)
  const uint32_t lane_row = (64 * wg + 16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * ROW_BYTES;
  const uint32_t lane_swz = lane % 8, lane_h = lane / 16;
  // bf16 sums in `wgmma` and leaves `part` alone (the compiler drops it)
  float acc[BT / 2], part[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = part[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    // the B tile was written through the generic proxy and is read by the
    // tensor cores through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consume_step<BT, KAHAN>(static_cast<const S*>(nullptr), smem_addr + s * STAGE_BYTES,
                            lane_row, lane_swz, lane_h, acc, part);
    mbar_arrive(empty + 8 * s);
  }

  // Accumulator i of lane l of warp w holds column 16w + l/4 + 8*((i/2)%2)
  // of the warpgroup's 64 and row 8*(i/4) + 2*(l%4) + i%2.
  float* yb = y + static_cast<long long>(b) * length;
  const int p_thread = p0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    const int p = p_thread + 8 * ((i / 2) % 2);
    const long long r = r0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    const long long s = r * hop + p;
    // KAHAN: the sum plus its last compensation
    if (p < hop && s < length) yb[s] = KAHAN ? acc[i] + part[i] : acc[i];
  }
}

template <typename S, int BT, bool KAHAN>
cudaError_t launch_bt(const void* sre, const void* sim, const void* kcT,
                      const void* ksT, void* y, int B, int F, int T, int Tp, int N,
                      int hop, int Fp, cudaStream_t st) {
  constexpr int SMEM = Synth<S>::STAGES * (1 + Synth<S>::PLANES) * TILE_BYTES +
                       RAW_SLOTS * raw_bytes<S, BT>() + 1024;
  CUtensorMap map_kc{}, map_ks{};
  if (!tile_map<S>(kcT, N, Fp, &map_kc) || !tile_map<S>(ksT, N, Fp, &map_ks))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      synthesis_tc_kernel<S, BT, KAHAN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int n_chunks = (N + hop - 1) / hop;
  const int rows = T + n_chunks - 1;
  const int length = N + hop * (T - 1);
  const dim3 grid((rows + BT - 1) / BT, (hop + BP - 1) / BP, B);
  synthesis_tc_kernel<S, BT, KAHAN><<<grid, NT, SMEM, st>>>(
      static_cast<const S*>(sre), static_cast<const S*>(sim), static_cast<float*>(y),
      F, T, Tp, N, hop, Fp, length, map_kc, map_ks);
  return cudaGetLastError();
}

// The row-tile width that pads the R rows least; the wider of two that tie.
template <typename S, bool KAHAN>
cudaError_t launch(const void* sre, const void* sim, const void* kcT,
                   const void* ksT, void* y, int B, int F, int T, int Tp, int N,
                   int hop, int Fp, cudaStream_t st) {
  const int rows = T + (N + hop - 1) / hop - 1;
  auto padded = [rows](int bt) { return (rows + bt - 1) / bt * bt; };
  if (padded(128) <= padded(112) && padded(128) <= padded(64))
    return launch_bt<S, 128, KAHAN>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
  if (padded(112) <= padded(64))
    return launch_bt<S, 112, KAHAN>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
  return launch_bt<S, 64, KAHAN>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
}

}  // namespace

// kcT, ksT are the kernels transposed, (N, Fp) in the storage type, zeros in
// the columns past F; Fp is a multiple of 32 (fp32) or 64 (bf16). The
// spectra's rows are Tp frames long, T rounded up to 16 bytes, zeros past T.
extern "C" int nnaudio_synthesis_ola(const void* sre, const void* sim,
                                     const void* kcT, const void* ksT, void* y,
                                     int B, int F, int T, int Tp, int N, int hop,
                                     int Fp, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
  // the longest row's running sum: every chunk, Re and -Im, every K chunk
  const long long steps = 2LL * ((N + hop - 1) / hop) * (Fp / Synth<float>::BK);
  if (steps > KAHAN_MIN_STEPS)
    return launch<float, true>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
  return launch<float, false>(sre, sim, kcT, ksT, y, B, F, T, Tp, N, hop, Fp, st);
}
