// int8 GEMM and polyphase int8 transposed conv for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of awr_tpu/ops/pallas_int8.py:
//
//   awr_s8_gemm_tc,  <- int8_matmul (:196, body _mm_kernel :190)
//   awr_s8_gemm         (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.
//                       The port runs every int8 conv of the ResNet
//                       encoder as im2col + this GEMM.
//   awr_s8_deconv    <- deconv4x4s2_int8 (:127, body _deconv_kernel :89)
//                       ConvTranspose2d(k4, s2, p1) on int8 codes as four
//                       polyphase (B*H*W, 4*C_in) @ (4*C_in, C_out) GEMMs,
//                       int32 accumulate, out = float(acc) * scale[oc],
//                       written as float32 or, rounded once, bfloat16 (the
//                       Pallas kernel's out_dtype).
//
// Plain versions: awr_tpu_torch/ops/int8.py (int8_matmul,
// deconv4x4s2_int8). Tiles and splits are chosen on the host
// (ops/int8_cuda.py: gemm_plan, deconv_plan).
//
// Bound. Most of resnet_18's GEMMs move more bytes than the int8 tensor
// cores need time for (the N = 64 shapes most of all); the deep ones
// (layers 3-4) are small and leave SMs idle. The deconv at the decoder's
// largest shape is bound by its output (B = 32, 256 -> 256 channels at
// 32x32 -> 64x64: 134 MB written in float32, 67 MB in bfloat16; 9.5 MB
// read).
//
// Design. Both kernels share one pipeline (Pipe, tc_setup, tc_claim, ...):
// - 288 threads a block: two consumer warpgroups (64 rows of the 128-row
//   tile each) and one producer warp whose one thread keeps TMA loads in
//   flight into a ring of stages in dynamic shared memory, a "full" and
//   an "empty" mbarrier a stage. The consumers run s8 wgmma (m64nNk32,
//   int32 accumulators in registers) on the stages that have arrived and
//   release a stage once the next one's products are issued.
// - Operand tiles are 128-byte K rows in the 128-byte swizzle that
//   wgmma reads. TMA fills zeros outside a tensor: rows past M, rows past
//   N and K past its end read as 0, which adds nothing to an integer sum.
// - GEMM: a stage is 128 bytes of K of the A tile (128 rows) and the B
//   tile (BN = 64 or 128 rows; B is given as its transpose (N, K), which
//   is how a conv weight lies already); a ring of 4 (BN 64) or 3 (BN 128)
//   stages, two blocks an SM. The tile goes through shared memory to one
//   TMA store; a grid with few tiles splits K over blockIdx.z and each
//   split adds its tile into a zeroed C with one TMA reduce-add (integer
//   addition: exact in any order). Where N % 4 != 0, C's rows are no
//   TMA stride and the tile is stored from registers. Needs K % 16 == 0
//   (TMA's 16-byte strides) and 16-byte aligned bases.
// - Deconv: no im2col in memory. A unit of work is 128 input pixels (a
//   tw x th x tb box of the NHWC codes), one row phase a, 64 output
//   channels, and both column phases c = 0, 1 in two accumulators. Output
//   column 2x + c reads input columns x - 1 + c + dj (dj = 0, 1): three
//   shifts sx = c + dj - 1 in {-1, 0, 1}, the middle one shared by both
//   phases. So for 128 channels of each row tap di, three stages: the A
//   box at (c0, x0 + sx, y0 + a + di - 1, b0), which TMA zero-fills
//   across the image border (exact: symmetric quantization maps 0 to 0),
//   and the weight boxes of the (c, dj) that read it (one, two, one).
//   Both column phases being in the unit, its output rows 2y + a are
//   whole runs of 2 tw floats: the tile is staged in shared memory
//   (beside the ring) and written by one TMA store of a box of the NCHW
//   output, in full sectors (the output is 93 % of deconv2's bytes). The
//   epilogue is __fmul_rn(__int2float_rn(acc), scale[oc]), stored as is
//   (float32) or rounded to nearest even (bfloat16; the plain version's
//   .to(torch.bfloat16) of the same float32 product). The TMA store
//   needs the output rows 2y + 1 16-byte aligned: 2W elements of 16
//   bytes' multiple (W even in float32, W % 4 == 0 in bfloat16); other
//   widths are stored by the threads from shared memory. One
//   persistent block an SM walks the units, its producer loading the
//   next unit while the consumers store one. Channels past C_in read as
//   zero in the A box, so the B box's K columns past a tap's C_in (the
//   next tap's weights) multiply zeros; rows past C_out (the next phase's
//   weights) give columns that are never stored. A first small kernel
//   lays the weight out per phase (s8_deconv_weights_kernel).
// - K % 16 != 0 (the 5x5 stem, K = 25): s8_gemm_kernel, byte loads into
//   padded shared rows and __dp4a on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---- the tensor-core pipeline ------------------------------------------

constexpr int kTcBM = 128;       // rows of A a block: 2 warpgroups x 64
constexpr int kTcBK = 128;       // bytes of K a stage: one swizzled row
constexpr int kTcThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumers = 256;
constexpr int kABytes = kTcBM * kTcBK;  // an A tile of a stage
constexpr int kDeconvBN = 64;           // output channels of a deconv tile
constexpr int kDeconvBNLog = 6;
static_assert(kDeconvBN == 1 << kDeconvBNLog, "kDeconvBN is a power of two");

// A ring of kStages stages of kStageBytes, then kExtra bytes of the
// block's own, then the ring's barriers.
template <int kStages_, int kStageBytes_, int kExtra_ = 0>
struct Pipe {
  static constexpr int kStages = kStages_;
  static constexpr int kStageBytes = kStageBytes_;
  static constexpr int kExtra = kExtra_;
  // the ring, the extra bytes, 2 * kStages barriers, and slack to align
  // to 1024
  static constexpr int kSmem =
      kStages * kStageBytes + kExtra + 16 * kStages + 1024;
};
template <int BN>
using GemmPipe = Pipe<BN == 128 ? 3 : 4, kABytes + BN * kTcBK>;
// an A tile and up to two weight tiles a stage; the extra bytes hold the
// output tile (128 pixels, 2 column phases, 64 channels; float32 at most)
using DeconvPipe = Pipe<4, kABytes + 2 * kDeconvBN * kTcBK,
                        kTcBM * 2 * kDeconvBN * 4>;

struct Ring {
  uint32_t tiles, extra, full, empty;
};

// The block's ring in dynamic shared memory; thread 0 initializes the
// barriers. Ends with the block's only __syncthreads.
template <class P>
__device__ __forceinline__ Ring tc_setup(uint8_t* smem) {
  Ring r;
  r.tiles = (smem_u32(smem) + 1023) & ~1023u;
  r.extra = r.tiles + P::kStages * P::kStageBytes;
  r.full = r.extra + P::kExtra;
  r.empty = r.full + 8 * P::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// Producer: the slot of stage i once the consumers have released it,
// and in `full` its barrier.
template <class P>
__device__ __forceinline__ uint32_t tc_claim(const Ring& r, int i,
                                             uint32_t* full) {
  const int s = i % P::kStages;
  mbar_wait(r.empty + 8 * s, ((i / P::kStages) & 1) ^ 1);
  *full = r.full + 8 * s;
  return r.tiles + s * P::kStageBytes;
}

// Consumers: the slot of stage i, once it has arrived.
template <class P>
__device__ __forceinline__ uint32_t tc_acquire(const Ring& r, int i) {
  const int s = i % P::kStages;
  mbar_wait(r.full + 8 * s, (i / P::kStages) & 1);
  return r.tiles + s * P::kStageBytes;
}

// Consumers: stage i's slot goes back to the producer.
template <class P>
__device__ __forceinline__ void tc_release(const Ring& r, int i) {
  mbar_arrive(r.empty + 8 * (i % P::kStages));
}

// Consumers, after committing stage i's products: once stage i - 1's are
// done, its slot goes back to the producer.
template <class P>
__device__ __forceinline__ void tc_release_previous(const Ring& r, int i) {
  wgmma_wait<1>();
  if (i > 0) tc_release<P>(r, i - 1);
}

// acc += A (64 rows at da) . B (BN rows at db)^T over one 128-byte stage:
// four k-steps of 32 bytes (2 descriptor units).
template <int BN>
__device__ __forceinline__ void mma_stage(int (&acc)[BN / 2], uint64_t da,
                                          uint64_t db) {
#pragma unroll
  for (int k = 0; k < kTcBK / 32; ++k)
    Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k);
}

template <int kN>
__device__ __forceinline__ void zero(int (&acc)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0;
}

// The consumers' generic pointer to shared address `addr`.
template <class T>
__device__ __forceinline__ T* shared_ptr(uint8_t* smem, uint32_t addr) {
  return reinterpret_cast<T*>(smem + (addr - smem_u32(smem)));
}

// How the GEMM's block writes its tile: staged in shared memory and
// written by one TMA store of a box of C (N % 4 == 0: C's rows are
// 16-byte strided), the same added into a zeroed C by one TMA reduce-add
// (split K), or stored from registers (N % 4 != 0).
enum GemmOut { kTmaStore = 0, kTmaAdd = 1, kDirect = 2 };

// C (M, N) int32 = A (M, K) int8 @ Bt (N, K) int8 ^T over the K stages
// [z * per_split, ...) of this block's split z.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
    s8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_c,
                         int32_t* __restrict__ C, int M, int N, int k_tiles,
                         int per_split, int out_mode) {
  using P = GemmPipe<BN>;
  extern __shared__ uint8_t smem[];
  const Ring ring = tc_setup<P>(smem);
  const int kt0 = blockIdx.z * per_split;
  const int nk = min(per_split, k_tiles - kt0);
  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {  // the producer
    if (lane != 0) return;
    for (int i = 0; i < nk; ++i) {
      uint32_t bar;
      const uint32_t slot = tc_claim<P>(ring, i, &bar);
      const int k = (kt0 + i) * kTcBK;
      mbar_expect_tx(bar, P::kStageBytes);
      tma_load_2d(slot, &map_a, bar, k, m0);
      tma_load_2d(slot + kABytes, &map_b, bar, k, n0);
    }
    return;
  }
  const int wg = warp / 4;
  int acc[BN / 2];
  zero(acc);
  fence_regs(acc);
  for (int i = 0; i < nk; ++i) {
    const uint32_t slot = tc_acquire<P>(ring, i);
    wgmma_fence();
    mma_stage<BN>(acc, sw128_desc(slot + wg * 64 * kTcBK),
                  sw128_desc(slot + kABytes));
    wgmma_commit();
    tc_release_previous<P>(ring, i);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // wgmma's accumulator layout: row 16 w + lane / 4 (+ 8 h), columns
  // 8 j + 2 (lane % 4) (+ e) in acc[4 j + 2 h + e]
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  if (out_mode == kDirect) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row0 + 8 * h;
      if (row >= M) continue;
      int32_t* crow = C + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + col0 + 8 * j;
        if (col < N) crow[col] = acc[4 * j + 2 * h];
        if (col + 1 < N) crow[col + 1] = acc[4 * j + 2 * h + 1];
      }
    }
    return;
  }
  // the (128, BN) int32 tile over the ring, once both warpgroups are done
  // reading it
  named_barrier(1, kConsumers);
  int32_t* tile = shared_ptr<int32_t>(smem, ring.tiles);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<int2*>(tile + (row0 + 8 * h) * BN + col0 + 8 * j) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  fence_proxy_async();
  named_barrier(1, kConsumers);
  if (threadIdx.x == 0) {
    if (out_mode == kTmaAdd)
      tma_reduce_add_2d(&map_c, ring.tiles, n0, m0);
    else
      tma_store_2d(&map_c, ring.tiles, n0, m0);
    bulk_commit_and_wait();
  }
}

// The deconv's output element T and its pair of column phases (2x, 2x + 1).
template <class T>
struct OutPair;
template <>
struct OutPair<float> {
  using Pair = float2;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ float2 make(float c0, float c1) {
    return make_float2(c0, c1);
  }
};
template <>
struct OutPair<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // each rounded to nearest even
  static __device__ __forceinline__ __nv_bfloat162 make(float c0, float c1) {
    return __floats2bfloat162_rn(c0, c1);
  }
};

// out (B, C_out, 2H, 2W) T = ConvTranspose2d(k4, s2, p1)(x) * scale, T
// float or __nv_bfloat16.
// map_x: 4-D map of x (B, H, W, C_in) int8 NHWC, box (128, tw, th, tb);
// map_w: 2-D map of wph (4 C_out, 4 C_in) int8, box (128, 64): for phase
// p = 2a + c, row p C_out + oc holds the taps t = 2 di + dj, C_in each;
// with tma_out (2W T 16-byte aligned), map_o<a>: 4-D T maps of the output
// rows 2y + a, (2W, H, C_out, B), box (2 tw, th, 64, tb). Persistent: block z
// takes the work units z, z + gridDim.x, ...; unit u is row phase u % 2,
// channel tile u / 2 % oc_tiles, pixel tile u / (2 oc_tiles). The
// producer runs on into the next unit while the consumers store one.
template <class T>
__global__ void __launch_bounds__(kTcThreads, 1)
    s8_deconv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_o0,
                           const __grid_constant__ CUtensorMap map_o1,
                           const float* __restrict__ scale,
                           T* __restrict__ out, int B, int H, int W,
                           int Cin, int Cout, int tw, int th, int tb,
                           int tma_out) {
  using P = DeconvPipe;
  using Out = OutPair<T>;
  using Pair = typename Out::Pair;
  constexpr int kBBytes = kDeconvBN * kTcBK;
  extern __shared__ uint8_t smem[];
  const Ring ring = tc_setup<P>(smem);
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const int oc_tiles = (Cout + kDeconvBN - 1) / kDeconvBN;
  const int units = 2 * oc_tiles * tiles_x * tiles_y * ((B + tb - 1) / tb);
  // stage 6 q + 3 di + (sx + 1) of a unit: channels [128 q, 128 q + 128),
  // row tap di, column shift sx
  const int nk = 6 * ((Cin + kTcBK - 1) / kTcBK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the unit's row phase, channel offset and pixel-tile origin
  auto unit = [&](int u, int& pa, int& oc0, int& x0, int& y0, int& b0) {
    pa = u & 1;
    oc0 = (u >> 1) % oc_tiles * kDeconvBN;
    const int tile = (u >> 1) / oc_tiles;
    x0 = tile % tiles_x * tw;
    y0 = tile / tiles_x % tiles_y * th;
    b0 = tile / (tiles_x * tiles_y) * tb;
  };
  if (warp == kConsumers / 32) {
    if (lane != 0) return;
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int pa, oc0, x0, y0, b0;
      unit(u, pa, oc0, x0, y0, b0);
      for (int k = 0; k < nk; ++k, ++i) {
        uint32_t bar;
        const uint32_t slot = tc_claim<P>(ring, i, &bar);
        const int c0 = k / 6 * kTcBK;
        const int di = k % 6 / 3;
        const int sx = k % 3 - 1;
        const int nb = sx == 0 ? 2 : 1;  // the (c, dj) with c + dj - 1 = sx
        mbar_expect_tx(bar, kABytes + nb * kBBytes);
        tma_load_4d(slot, &map_x, bar, c0, x0 + sx, y0 + pa + di - 1, b0);
        for (int j = 0; j < nb; ++j) {
          const int c = sx == 1 ? 1 : j;
          const int tap = 2 * di + sx + 1 - c;
          tma_load_2d(slot + kABytes + j * kBBytes, &map_w, bar,
                      tap * Cin + c0, (2 * pa + c) * Cout + oc0);
        }
      }
    }
    return;
  }
  const int wg = warp / 4;
  // tw and th are powers of two
  const int lw = __ffs(tw) - 1;
  const int lh = __ffs(th) - 1;
  Pair* tile2 = shared_ptr<Pair>(smem, ring.extra);
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int OH = 2 * H;
  const int OW = 2 * W;
  int i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int pa, oc0, x0, y0, b0;
    unit(u, pa, oc0, x0, y0, b0);
    int acc0[kDeconvBN / 2], acc1[kDeconvBN / 2];  // column phases c = 0, 1
    zero(acc0);
    zero(acc1);
    fence_regs(acc0);
    fence_regs(acc1);
    for (int k0 = 0; k0 < nk; k0 += 6) {
#pragma unroll
      for (int q = 0; q < 6; ++q, ++i) {
        const uint32_t slot = tc_acquire<P>(ring, i);
        const uint64_t da = sw128_desc(slot + wg * 64 * kTcBK);
        const uint64_t db0 = sw128_desc(slot + kABytes);
        const uint64_t db1 = sw128_desc(slot + kABytes + kBBytes);
        wgmma_fence();
        if (q % 3 == 0) mma_stage<kDeconvBN>(acc0, da, db0);  // sx = -1
        if (q % 3 == 1) {                                     // sx = 0
          mma_stage<kDeconvBN>(acc0, da, db0);
          mma_stage<kDeconvBN>(acc1, da, db1);
        }
        if (q % 3 == 2) mma_stage<kDeconvBN>(acc1, da, db0);  // sx = 1
        wgmma_commit();
        wgmma_wait<1>();
        if (k0 + q > 0) tc_release<P>(ring, i - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    tc_release<P>(ring, i - 1);

    // Stage the scaled tile as [bz][oc][y][2 x + c] elements: each output
    // row 2 y + a of an image and channel is a run of 2 tw. The previous
    // unit's store must have read the buffer first.
    if (threadIdx.x == 0) bulk_wait_read();
    named_barrier(1, kConsumers);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;  // the tile's pixel (bz, y, x), x fastest
      const int x = r & (tw - 1);
      const int y = (r >> lw) & (th - 1);
      const int bz = r >> (lw + lh);
#pragma unroll
      for (int j = 0; j < kDeconvBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oc = 8 * j + 2 * (lane % 4) + e;
          const float s = oc0 + oc < Cout ? __ldg(scale + oc0 + oc) : 0.0f;
          const int a = 4 * j + 2 * h + e;
          tile2[((((bz * kDeconvBN + oc) << lh) + y) << lw) + x] =
              Out::make(__fmul_rn(__int2float_rn(acc0[a]), s),
                        __fmul_rn(__int2float_rn(acc1[a]), s));
        }
      }
    }
    if (tma_out) {  // one 4-D box: (2 tw, th, 64, tb) of the output
      fence_proxy_async();
      named_barrier(1, kConsumers);
      if (threadIdx.x == 0) {
        tma_store_4d(pa ? &map_o1 : &map_o0, ring.extra, 2 * x0, y0, oc0, b0);
        bulk_commit();
      }
      continue;
    }
    named_barrier(1, kConsumers);
    const int n2 = tb * kDeconvBN << (lh + lw);  // pairs of the tile
    for (int idx = threadIdx.x; idx < n2; idx += kConsumers) {
      const int x = x0 + (idx & (tw - 1));
      const int line = idx >> lw;  // (bz, oc, y)
      const int y = y0 + (line & (th - 1));
      const int oc = oc0 + ((line >> lh) & (kDeconvBN - 1));
      const int b = b0 + (line >> (lh + kDeconvBNLog));
      if (x < W && y < H && b < B && oc < Cout)
        *reinterpret_cast<Pair*>(
            out + ((static_cast<size_t>(b) * Cout + oc) * OH + 2 * y + pa) *
                      OW + 2 * x) = tile2[idx];
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();
}

// wph (4, C_out, 4 C_in) = the deconv's per-phase weight operands of wq
// (C_in, C_out, 4, 4): phase p = 2a + c, tap t = 2 di + dj reads kernel
// element (3 - a - 2 di, 3 - c - 2 dj) (awr_tpu_torch/ops/int8.py
// prep_deconv_weights, transposed). A C_in x C_out transpose for each
// (p, t), 32 x 32 tiles through shared memory. Block (32, 8).
__global__ void s8_deconv_weights_kernel(const int8_t* __restrict__ wq,
                                         int8_t* __restrict__ wph, int Cin,
                                         int Cout) {
  __shared__ int8_t tile[32][33];
  const int p = blockIdx.z >> 2;
  const int t = blockIdx.z & 3;
  const int kk = (3 - (p >> 1) - 2 * (t >> 1)) * 4 + 3 - (p & 1) - 2 * (t & 1);
  const int ci0 = blockIdx.x * 32;
  const int oc0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int ci = ci0 + r;
    const int oc = oc0 + threadIdx.x;
    if (ci < Cin && oc < Cout)
      tile[r][threadIdx.x] = wq[(static_cast<size_t>(ci) * Cout + oc) * 16 + kk];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int oc = oc0 + r;
    const int ci = ci0 + threadIdx.x;
    if (ci < Cin && oc < Cout)
      wph[(static_cast<size_t>(p * Cout + oc) * 4 + t) * Cin + ci] =
          tile[threadIdx.x][r];
  }
}

// ---- the byte-load path (K % 16 != 0) ----------------------------------

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;                // bytes of K per slice
constexpr int kLdw = kBK / 4 + 1;      // shared row stride, 32-bit words
constexpr int kThreads = 256;
constexpr int kTM = kBM / 16;          // 8 rows a thread
constexpr int kTN = kBN / 16;          // 4 columns a thread

__device__ __forceinline__ void store_words(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// 16 bytes of row `row` of a (rows, K) int8 matrix from column k, byte
// by byte; zero past the last row and past K.
__device__ __forceinline__ int4 load_row16(const int8_t* __restrict__ base,
                                           int row, int rows, int k, int K) {
  if (row >= rows || k >= K) return make_int4(0, 0, 0, 0);
  const int8_t* p = base + static_cast<size_t>(row) * K + k;
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (k + i < K)
      w[i / 4] |= static_cast<int>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// C (M, N) int32 = A (M, K) int8 @ Bt (N, K) int8 ^T: a 128 x 64 tile a
// block, K in 32-byte slices staged in shared rows padded to 9 words (no
// bank conflicts), an 8 x 4 block of outputs a thread with __dp4a.
__global__ void __launch_bounds__(kThreads)
    s8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                   int32_t* __restrict__ C, int M, int N, int K) {
  __shared__ int sA[kBM * kLdw];
  __shared__ int sB[kBN * kLdw];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  // each thread stages one 16-byte chunk of A (and threads < 128 one of B)
  const int lrow = tid >> 1;
  const int lk = (tid & 1) * 16;
  // output mapping: 16 threads along N, so a warp's stores are contiguous
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    store_words(&sA[lrow * kLdw + lk / 4],
                load_row16(A, m0 + lrow, M, k0 + lk, K));
    if (tid < 2 * kBN)
      store_words(&sB[lrow * kLdw + lk / 4],
                  load_row16(Bt, n0 + lrow, N, k0 + lk, K));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 4; ++kk) {
      int a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = sA[(ty + 16 * i) * kLdw + kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = sB[(tx + 16 * j) * kLdw + kk];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) C[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once a device (`done` is the kernel's own flag array).
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !done[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
  }
  return static_cast<int>(err);
}

template <int BN>
int launch_gemm_tc(const int8_t* A, const int8_t* Bt, int32_t* C, int M,
                   int N, int K, int split, int per_split,
                   cudaStream_t stream) {
  CUtensorMap ma, mb, mc{};
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(N)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box_a[2] = {kTcBK, kTcBM};
  const cuuint32_t box_b[2] = {kTcBK, BN};
  // C as int32 (N, M), boxes of (BN, 128)
  const int out_mode = N % 4 ? kDirect : split > 1 ? kTmaAdd : kTmaStore;
  const cuuint64_t dims_c[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t stride_c[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box_c[2] = {BN, kTcBM};
  if (split > 1 && out_mode == kDirect) return -3;
  int err = encode_s8(&ma, A, 2, dims_a, stride, box_a);
  if (err == 0) err = encode_s8(&mb, Bt, 2, dims_b, stride, box_b);
  if (err == 0 && out_mode != kDirect)
    err = encode(&mc, CU_TENSOR_MAP_DATA_TYPE_INT32,
                 CU_TENSOR_MAP_SWIZZLE_NONE, C, 2, dims_c, stride_c, box_c);
  static bool smem_set[64];
  if (err == 0)
    err = allow_smem(s8_gemm_wgmma_kernel<BN>, GemmPipe<BN>::kSmem, smem_set);
  if (err != 0) return err;
  const int k_tiles = (K + kTcBK - 1) / kTcBK;
  const dim3 grid((M + kTcBM - 1) / kTcBM, (N + BN - 1) / BN, split);
  s8_gemm_wgmma_kernel<BN>
      <<<grid, kTcThreads, GemmPipe<BN>::kSmem, stream>>>(
          ma, mb, mc, C, M, N, k_tiles, per_split, out_mode);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_deconv(const int8_t* x, const int8_t* wq, int8_t* wph,
                  const float* scale, T* out, int B, int H, int W,
                  int Cin, int Cout, int tw, int th, int tb,
                  cudaStream_t stream) {
  CUtensorMap mx, mw, mo[2] = {};
  const cuuint64_t dims_x[4] = {
      static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
      static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides_x[3] = {
      static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W) * Cin,
      static_cast<cuuint64_t>(H) * W * Cin};
  const cuuint32_t box_x[4] = {kTcBK, static_cast<cuuint32_t>(tw),
                               static_cast<cuuint32_t>(th),
                               static_cast<cuuint32_t>(tb)};
  const cuuint64_t dims_w[2] = {static_cast<cuuint64_t>(4) * Cin,
                                static_cast<cuuint64_t>(4) * Cout};
  const cuuint64_t strides_w[1] = {static_cast<cuuint64_t>(4) * Cin};
  const cuuint32_t box_w[2] = {kTcBK, kDeconvBN};
  // the output rows 2y + a: 16-byte aligned and strided when a row of 2W
  // elements is (float32: W even; bfloat16: W % 4 == 0)
  const cuuint64_t row = static_cast<cuuint64_t>(2) * W * sizeof(T);
  const int tma_out = row % 16 == 0;
  const cuuint64_t dims_o[4] = {
      static_cast<cuuint64_t>(2) * W, static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(B)};
  // byte strides: two output rows (a step of y), a channel's 2H rows, an
  // image's C_out channels
  const cuuint64_t strides_o[3] = {2 * row, 2 * row * H, 2 * row * H * Cout};
  const cuuint32_t box_o[4] = {static_cast<cuuint32_t>(2 * tw),
                               static_cast<cuuint32_t>(th), kDeconvBN,
                               static_cast<cuuint32_t>(tb)};
  if (tw * th * tb != kTcBM) return -3;
  int err = encode_s8(&mx, x, 4, dims_x, strides_x, box_x);
  if (err == 0) err = encode_s8(&mw, wph, 2, dims_w, strides_w, box_w);
  for (int a = 0; a < 2 && err == 0 && tma_out; ++a)
    err = encode(&mo[a], OutPair<T>::kTma, CU_TENSOR_MAP_SWIZZLE_NONE,
                 out + static_cast<size_t>(2) * W * a, 4, dims_o, strides_o,
                 box_o);
  static bool smem_set[64];
  if (err == 0)
    err = allow_smem(s8_deconv_wgmma_kernel<T>, DeconvPipe::kSmem, smem_set);
  if (err != 0) return err;
  s8_deconv_weights_kernel<<<dim3((Cin + 31) / 32, (Cout + 31) / 32, 16),
                             dim3(32, 8), 0, stream>>>(wq, wph, Cin, Cout);
  const int units = 2 * ((W + tw - 1) / tw) * ((H + th - 1) / th) *
                    ((B + tb - 1) / tb) * ((Cout + kDeconvBN - 1) / kDeconvBN);
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const dim3 grid(units < sms ? units : sms);
  s8_deconv_wgmma_kernel<T><<<grid, kTcThreads, DeconvPipe::kSmem, stream>>>(
      mx, mw, mo[0], mo[1], scale, out, B, H, W, Cin, Cout, tw, th, tb,
      tma_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launchers: enqueue on `stream`, never synchronize, return 0 when the
// launch was accepted, else a CUDA error code (> 0), -1 when libcuda
// has no tensor-map encoder, -2 when it refuses a map, -3 for a tile
// width the library was not built for, a split it cannot add or a pixel
// tile that is not 128 pixels.

// Dynamic shared memory of a block of the GEMM at tile width `which` (64
// or 128), or of the deconv (`which` 0).
extern "C" int awr_s8_tc_smem(int which) {
  return which == 64    ? GemmPipe<64>::kSmem
         : which == 128 ? GemmPipe<128>::kSmem
         : which == 0   ? DeconvPipe::kSmem
                        : -3;
}

// K % 16 == 0 (TMA's 16-byte strides), A, Bt and C 16-byte aligned;
// split > 1 adds into a zeroed C and needs N % 4 == 0.
extern "C" int awr_s8_gemm_tc(const int8_t* A, const int8_t* Bt, int32_t* C,
                              int M, int N, int K, int bn, int split,
                              int per_split, cudaStream_t stream) {
  if (bn == 64)
    return launch_gemm_tc<64>(A, Bt, C, M, N, K, split, per_split, stream);
  if (bn == 128)
    return launch_gemm_tc<128>(A, Bt, C, M, N, K, split, per_split, stream);
  return -3;
}

// Any K (the byte-load path).
extern "C" int awr_s8_gemm(const int8_t* A, const int8_t* Bt, int32_t* C,
                           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  s8_gemm_kernel<<<grid, kThreads, 0, stream>>>(A, Bt, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// C_in % 16 == 0, x and out 16-byte aligned, tw * th * tb == 128; wph:
// scratch of 16 C_in C_out bytes, 16-byte aligned, for the weight
// operands that s8_deconv_weights_kernel makes from wq first; out is
// float32, or bfloat16 where out_bf16.
extern "C" int awr_s8_deconv(const int8_t* x, const int8_t* wq, int8_t* wph,
                             const float* scale, void* out, int B, int H,
                             int W, int Cin, int Cout, int tw, int th, int tb,
                             int out_bf16, cudaStream_t stream) {
  if (out_bf16)
    return launch_deconv(x, wq, wph, scale, static_cast<__nv_bfloat16*>(out),
                         B, H, W, Cin, Cout, tw, th, tb, stream);
  return launch_deconv(x, wq, wph, scale, static_cast<float*>(out), B, H, W,
                       Cin, Cout, tw, th, tb, stream);
}
