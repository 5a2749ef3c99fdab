// Dense bf16 layer with its bias, ReLU and bf16 rounding in the GEMM's
// epilogue (K3), for the PSF surrogate's MLPs (Hopper).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (sdirt_tpu/render/mlp_fast.py: bf16 dots with preferred_element_type f32,
// then bias, ReLU and the cast), which fuses the elementwise tail into its
// GEMMs on the TPU. In PyTorch the same layer is torch.mm with an f32 output
// and three passes over that f32 tensor (bias add, ReLU, cast to bf16): at
// the render's 4 x 2 x 512 x 768 rows and width 512 each layer writes, reads
// and writes again a 6.4 GB f32 activation, ~42 GB a layer, ~3/4 of the
// render's device time. This kernel keeps the f32 sums in registers.
//
// It computes, for one layer,
//
//   C[i, j] = bf16_rne(max(sum_k A[i, k] B[j, k] + bias, 0))
//
// with bf16 A [M, K] and B [N, K] (both K-contiguous), f32 products and
// sums, the f32 bias along j (a dense layer: A the activations [rows, K],
// B the torch Linear weight [out, K], C [rows, out]) or along i (the
// tap-major head: A the weight [ks*ks, K], B the activations, so that
// C = [ks*ks, rows], the layout K2 reads). The numbers are those of
// torch.mm(out_dtype=f32) + add + relu + cast but for the order of the f32
// sums.
//
// Bound on an H100 SXM, per layer at the render's 3 145 728 rows: width
// 512 -> 512 moves 6.44 GB (bf16 in and out; 1.92 ms at 3.35 TB/s) and
// does 1.65 TFLOP (1.67 ms at 989 TFLOP/s); narrower layers are bound by
// their bytes. Every layer sits near the line, so loads, tensor-core work
// and the epilogue have to overlap.
//
// Design.
//  * A persistent grid, one block per SM, walks over output tiles of
//    BM = 128 x BN (64, 128 or 256, chosen by the caller from N) with the
//    weight's tile index fastest, so that the tiles that read one block of
//    activations run at about the same time and share it in L2; a layer's
//    weights (at most 512 KB) stay in the 50 MB L2.
//  * Warp specialisation, 3 warpgroups: one thread of the first starts TMA
//    loads of the A and B tiles, 64 columns of K at a time (128-byte
//    swizzled, the layout wgmma reads), into a ring of shared-memory stages
//    (3, 6 or 8 for BN 256, 128 or 64: as many as fit beside the output's
//    staging tile), each guarded by a "full" and an "empty" mbarrier; it runs ahead
//    over the tile sequence, so the next tile's loads overlap this tile's
//    epilogue. The other two warpgroups each take 64 rows of the tile and
//    run wgmma m64nBNk16 with f32 accumulators in registers
//    (setmaxnreg moves registers from the loader to them).
//  * The epilogue adds the f32 bias, applies the ReLU and rounds to bf16 in
//    those registers; the f32 tile never leaves them. Each consumer writes
//    its bf16 half tile to a staging tile in shared memory (in TMA's
//    128-byte swizzle, free of bank conflicts) and one thread hands it to
//    TMA stores of 64 x 64 boxes, which run on while the warpgroup starts
//    the next tile's products. Storing pairs of bf16 straight from the
//    registers instead (8 rows x 16 bytes a warp instruction) held every
//    layer to ~0.6-0.7 TB/s of output on the H100.
//  * Ragged edges: TMA fills rows and columns outside A or B with zeros
//    (K not a multiple of 64, the last row tile) and does not store outside
//    C. Row pitches must be multiples of 16 bytes: the wrapper pads the
//    first layer's K = 3 to 8 with zeros, which add exact zeros to the sums,
//    and gives C a pitch rounded up to 8 elements.
//  * A wait on an mbarrier that outlasts WAIT_LIMIT_NS traps (a launch
//    error) instead of hanging the card.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (render/dense_bf16.py); no PyTorch headers. The TMA
// descriptors are encoded on the host by cuTensorMapEncodeTiled, looked up
// at run time (cudaGetDriverEntryPoint), so the library does not link
// libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // tile rows: 64 per consumer warpgroup
constexpr int BK = 64;              // K columns per stage: one 128-byte swizzle row
constexpr int THREADS = 384;        // loader warpgroup + 2 consumer warpgroups
constexpr int SMEM_MAX = 232448;    // bytes a block may use on sm_90
constexpr uint64_t WAIT_LIMIT_NS = 20000000000ull;
constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;
// the registers ptxas must give each thread at launch, so that the loader's
// release covers the consumers' request (65536 / 384, rounded down to 8)
constexpr int LAUNCH_REGS = 168;

// shared memory: 1024 bytes of alignment slack, the ring of stages (an A
// and a B tile each), the output tile's staging (BM x bn bf16) and the
// ring's 2 mbarriers a stage; as many stages as fit
__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * BK * 2; }
__host__ __device__ constexpr int staging_bytes(int bn) { return BM * bn * 2; }
__host__ __device__ constexpr int stages(int bn) {
  return (SMEM_MAX - 1024 - staging_bytes(bn) - 256) / stage_bytes(bn);
}
__host__ __device__ constexpr int smem_bytes(int bn) {
  return 1024 + stages(bn) * stage_bytes(bn) + staging_bytes(bn) + 2 * stages(bn) * 8;
}

// --- shared memory, mbarriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
}

// TMA: the box at (c0 along K, c1 along rows) of `map` into shared memory
// at dst; completes `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA: shared memory at src to the box at (c0 along columns, c1 along rows)
// of `map`, in this thread's bulk group; elements outside the tensor are not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand tile written by TMA
// with the 128-byte swizzle: rows of 64 bf16 (128 B), 8-row groups 1024 B
// apart (SBO), start address >> 4 in bits 0-13, swizzle mode 1 in bits 62-63.
// The tile must start on a 1024-byte boundary; the k-th 16-column slice of
// it starts 32 k bytes further (+2 k in the descriptor).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (it does not see that the hardware writes them).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]^T from shared memory, both K-major;
// `accumulate` 0 overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

// --- the kernel ------------------------------------------------------------

// Tile t's block indices, the weight's index fastest: along N for a dense
// layer (B is the weight), along M for the tap-major head (A is).
template <bool BIAS_M>
__device__ __forceinline__ void tile_coords(int t, int num_m, int num_n, int& mb, int& nb) {
  if (BIAS_M) {
    mb = t % num_m;
    nb = t / num_m;
  } else {
    mb = t / num_n;
    nb = t % num_n;
  }
}

template <int BN, bool BIAS_M>
__global__ void __launch_bounds__(THREADS, 1)
    dense_bf16_relu_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const float* __restrict__ bias, int m, int n, int k) {
  constexpr int S = stages(BN);
  constexpr uint32_t A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_a = (raw + 1023u) & ~1023u;   // S tiles of A, then S of B
  const uint32_t s_b = s_a + S * A_BYTES;
  const uint32_t s_c = s_b + S * B_BYTES;        // the output tile, 2 halves
  const uint32_t bars = s_c + staging_bytes(BN); // full[S], then empty[S]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int num_m = (m + BM - 1) / BM, num_n = (n + BN - 1) / BN;
  const int num_k = (k + BK - 1) / BK, tiles = num_m * num_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // loader: one thread keeps the ring full, over every tile of this block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LOADER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mb, nb;
        tile_coords<BIAS_M>(t, num_m, num_n, mb, nb);
        for (int kb = 0; kb < num_k; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);   // the first round passes
          mbar_expect_tx(full(stage), A_BYTES + B_BYTES);
          tma_load(s_a + stage * A_BYTES, &map_a, kb * BK, mb * BM, full(stage));
          tma_load(s_b + stage * B_BYTES, &map_b, kb * BK, nb * BN, full(stage));
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c takes rows 64 c .. 64 c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this warpgroup's 64 rows of the output tile: BN / 64 boxes of 64 x 64
    // bf16, each in TMA's 128-byte swizzle (16-byte chunk q of row r at
    // chunk q ^ (r % 8)), so the stores below hit 32 distinct banks
    const uint32_t s_out = s_c + c * (64 * BN * 2);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mb, nb;
      tile_coords<BIAS_M>(t, num_m, num_n, mb, nb);
      for (int kb = 0; kb < num_k; ++kb) {
        mbar_wait(full(stage), phase);
        const uint64_t da = smem_desc(s_a + stage * A_BYTES + c * 64 * BK * 2);
        const uint64_t db = smem_desc(s_b + stage * B_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(empty(stage));
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: thread (warp, lane) holds rows r and r + 8, r = 16 warp +
      // lane / 4, columns 8 j + 2 (lane % 4) + {0, 1} of its warpgroup's
      // 64 x BN block. Bias, ReLU and bf16 rounding in registers, then
      // through the staging tile to device memory by TMA, which runs on
      // while the next tile's products start.
      const int r = warp * 16 + lane / 4;
      const int row0 = mb * BM + c * 64 + r;
      const int col0 = nb * BN + 2 * (lane % 4);
      float bias_row[2] = {0.f, 0.f};
      if (BIAS_M) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (row0 + 8 * i < m) bias_row[i] = __ldg(bias + row0 + 8 * i);
      }
      // the previous tile's stores have read the staging tile
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;
        float b0 = 0.f, b1 = 0.f;
        if (!BIAS_M) {
          if (col < n) b0 = __ldg(bias + col);
          if (col + 1 < n) b1 = __ldg(bias + col + 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v0 = fmaxf(acc[4 * j + 2 * i] + (BIAS_M ? bias_row[i] : b0), 0.f);
          const float v1 = fmaxf(acc[4 * j + 2 * i + 1] + (BIAS_M ? bias_row[i] : b1), 0.f);
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          const int row = r + 8 * i;   // row % 8 == lane / 4
          const uint32_t addr = s_out + (j / 8) * 8192 + row * 128 +
                                (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_store(&map_c, s_out + q * 8192, nb * BN + q * 64, mb * BM + c * 64);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    // the stores have finished before the block's shared memory goes
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// --- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The TMA map of a row-major bf16 [rows, cols] matrix with a row pitch of
// `pitch` elements, in boxes of 64 columns (one 128-byte swizzle row) x
// box_rows.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols, int64_t pitch,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returned when ptxas gave the kernel another register count than the one
// setmaxnreg's budget assumes (launching it could deadlock) or when the
// TMA encoder (cuTensorMapEncodeTiled) is missing or refuses the operands.
constexpr int ERR_REGISTERS = 1001, ERR_TENSOR_MAP = 1002;

// C [m, n] (row pitch ldc) = relu(A [m, k] B [n, k]^T + bias) in bf16.
template <int BN, bool BIAS_M>
int launch(const void* a, int64_t m, const void* b, int64_t n, int k, const float* bias,
           void* c, int64_t ldc, cudaStream_t stream) {
  auto kernel = dense_bf16_relu_kernel<BN, BIAS_M>;
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  if (regs != LAUNCH_REGS) return ERR_REGISTERS;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b, map_c;
  if (!tensor_map(&map_a, a, m, k, k, BM) || !tensor_map(&map_b, b, n, k, k, BN) ||
      !tensor_map(&map_c, c, m, n, ldc, 64))
    return ERR_TENSOR_MAP;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem_bytes(BN), stream>>>(map_a, map_b, map_c, bias, (int)m, (int)n,
                                                     k);
  return (int)cudaGetLastError();
}

}  // namespace

// relu(x w^T + b) in bf16: x [rows, k] and w [n, k] bf16 (k a multiple of 8,
// both 16-byte aligned), b [n] f32; out [rows, n] bf16, or with tapmajor
// [n, rows] (its product w x^T, the bias along its rows), with a row pitch
// of ld elements (a multiple of 8, at least its row's length; out 16-byte
// aligned). bn is the tile width along the product's columns: 64, 128 or
// 256, and 256 with tapmajor. Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for shapes the
// kernel does not take, or one of the ERR_ codes above.
extern "C" int dense_bf16_relu(const void* x, const void* w, const void* b, void* out,
                               long long rows, int n, int k, long long ld, int bn,
                               int tapmajor, void* stream) {
  const long long cols = tapmajor ? rows : n;
  if (rows <= 0 || rows > 0x7fffffffLL || n <= 0 || k <= 0 || k % 8 != 0 || ld % 8 != 0 ||
      ld < cols || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tapmajor) {
    if (bn != 256) return (int)cudaErrorInvalidValue;
    return launch<256, true>(w, n, x, rows, k, bias, out, ld, s);
  }
  switch (bn) {
    case 64: return launch<64, false>(x, rows, w, n, k, bias, out, ld, s);
    case 128: return launch<128, false>(x, rows, w, n, k, bias, out, ld, s);
    case 256: return launch<256, false>(x, rows, w, n, k, bias, out, ld, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
