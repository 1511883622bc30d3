// int8 GEMM and polyphase int8 transposed conv for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of awr_tpu/ops/pallas_int8.py:
//
//   awr_s8_gemm      <- int8_matmul (:196, body _mm_kernel :190)
//                       (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.
//                       The port runs every int8 conv of the ResNet
//                       encoder as im2col + this GEMM.
//   awr_s8_deconv    <- deconv4x4s2_int8 (:127, body _deconv_kernel :89)
//                       ConvTranspose2d(k4, s2, p1) on int8 codes as four
//                       polyphase (B*H*W, 4*C_in) @ (4*C_in, C_out) GEMMs,
//                       int32 accumulate, out = float(acc) * scale[oc].
//
// Plain versions: awr_tpu_torch/ops/int8.py (int8_matmul,
// deconv4x4s2_int8).
//
// Bound. At the decoder's shapes the deconv is bound by its float32
// output (B = 32, 256 -> 256 channels at 32x32 -> 64x64: 134 MB written
// against 9.5 MB read and 9 GMAC). The im2col GEMMs of the encoder are
// bound by the int8 tensor-core rate only where K and N are both large;
// most of them move more bytes than the tensor cores need time for.
//
// Design (simple first; tensor cores are later work). Both kernels share
// one main loop: a 128 x 64 output tile per 256-thread block, K walked
// in 32-byte slices; the A slice (128 x 32 bytes) and the B slice (64 x 32
// bytes, K contiguous per output column) are staged in shared memory with
// rows padded to 9 words (no bank conflicts), then each thread forms an
// 8 x 4 block of outputs with __dp4a (four int8 products and an int32
// add per instruction). No cp.async, no double buffering: four blocks an
// SM hide the global loads.
//
// - GEMM: B is given as its transpose (N, K), K contiguous, which is how
//   a conv weight (C_out, C_in * kh * kw) lies already. 16-byte loads
//   when K % 16 == 0 and both bases are 16-byte aligned; otherwise byte
//   loads (the 5x5 stem has K = 25). Rows past M, columns past N and the
//   K tail read as zero; stores are bounds-checked.
// - Deconv: no im2col in memory. A row is an output pixel (b, m, n) of
//   phase (a, c) = (blockIdx.x % 4) / 2, % 2; its K = 4 * C_in entries are
//   the 2x2 input patch x[b, m - 1 + a + di, n - 1 + c + dj, :] (NHWC, so
//   each 16-byte load is 16 channels of one tap), zero outside the image:
//   symmetric quantization maps 0 to 0, so the zero padding is exact. The
//   four phases of one pixel tile are neighbouring blocks, so their
//   interleaved float32 stores at (2m + a, 2n + c) meet in L2. The
//   epilogue writes NCHW float32 directly; consecutive threads own
//   consecutive pixels, so a warp's stores are contiguous in 8-byte steps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// 16 bytes of row `row` of a (rows, K) int8 matrix from column k; zero
// past the last row and past K.
template <bool kVec>
__device__ __forceinline__ int4 load_row16(const int8_t* __restrict__ base,
                                           int row, int rows, int k, int K) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= rows || k >= K) return v;
  const int8_t* p = base + static_cast<size_t>(row) * K + k;
  if (kVec) return *reinterpret_cast<const int4*>(p);
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (k + i < K)
      w[i / 4] |= static_cast<int>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// acc[i][j] += dot(sA row ra + 16 i, sB row cb + 16 j) over one K slice.
__device__ __forceinline__ void dp4a_slice(const int* __restrict__ sA,
                                           const int* __restrict__ sB, int ra,
                                           int cb, int (&acc)[kTM][kTN]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 4; ++kk) {
    int a[kTM], b[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) a[i] = sA[(ra + 16 * i) * kLdw + kk];
#pragma unroll
    for (int j = 0; j < kTN; ++j) b[j] = sB[(cb + 16 * j) * kLdw + kk];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// C (M, N) int32 = A (M, K) int8 @ Bt (N, K) int8 ^T.
template <bool kVec>
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
                load_row16<kVec>(A, m0 + lrow, M, k0 + lk, K));
    if (tid < 2 * kBN)
      store_words(&sB[lrow * kLdw + lk / 4],
                  load_row16<kVec>(Bt, n0 + lrow, N, k0 + lk, K));
    __syncthreads();
    dp4a_slice(sA, sB, ty, tx, acc);
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

// out (B, C_out, 2H, 2W) float32 = ConvTranspose2d(k4, s2, p1)(x) * scale.
// x (B, H, W, C_in) int8 NHWC; wph (4, C_out, 4 C_in) int8: for phase
// p = 2a + c, row oc holds the taps (di, dj) row-major, C_in each.
// Needs C_in % 16 == 0 and 16-byte aligned x and wph.
__global__ void __launch_bounds__(kThreads)
    s8_deconv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wph,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int B, int H, int W, int Cin, int Cout) {
  __shared__ int sA[kBM * kLdw];
  __shared__ int sB[kBN * kLdw];
  const int tid = threadIdx.x;
  const int phase = blockIdx.x & 3;
  const int pa = phase >> 1;
  const int pc = phase & 1;
  const int m0 = (blockIdx.x >> 2) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int HW = H * W;
  const int M = B * HW;
  const int K = 4 * Cin;
  const int8_t* __restrict__ Bt = wph + static_cast<size_t>(phase) * Cout * K;

  // the pixel whose A row this thread stages
  const int lrow = tid >> 1;
  const int lk = (tid & 1) * 16;
  const int lp = m0 + lrow;
  const int lb = lp / HW;
  const int lm = (lp - lb * HW) / W;
  const int ln = lp - lb * HW - lm * W;
  // output mapping: 16 threads along the pixels (coalesced NCHW stores)
  const int tm = tid & 15;
  const int tn = tid >> 4;
  int acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    int4 v = make_int4(0, 0, 0, 0);
    const int k = k0 + lk;
    const int t = k / Cin;  // tap (di, dj) = (t / 2, t % 2)
    const int ci = k - t * Cin;
    const int iy = lm - 1 + pa + (t >> 1);
    const int ix = ln - 1 + pc + (t & 1);
    if (lp < M && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const int4*>(
          x + ((static_cast<size_t>(lb) * H + iy) * W + ix) * Cin + ci);
    store_words(&sA[lrow * kLdw + lk / 4], v);
    if (tid < 2 * kBN)
      store_words(&sB[lrow * kLdw + lk / 4],
                  load_row16<true>(Bt, n0 + lrow, Cout, k, K));
    __syncthreads();
    dp4a_slice(sA, sB, tm, tn, acc);
    __syncthreads();
  }
  const int OH = 2 * H;
  const int OW = 2 * W;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = m0 + tm + 16 * i;
    if (p >= M) continue;
    const int b = p / HW;
    const int m = (p - b * HW) / W;
    const int n = p - b * HW - m * W;
    const size_t pix = static_cast<size_t>(2 * m + pa) * OW + 2 * n + pc;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int oc = n0 + tn + 16 * j;
      if (oc < Cout)
        out[(static_cast<size_t>(b) * Cout + oc) * OH * OW + pix] =
            __fmul_rn(__int2float_rn(acc[i][j]), scale[oc]);
    }
  }
}

}  // namespace

// Launchers: enqueue on `stream`, never synchronize, return
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int awr_s8_gemm(const int8_t* A, const int8_t* Bt, int32_t* C,
                           int M, int N, int K, int vec,
                           cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (vec)
    s8_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(A, Bt, C, M, N, K);
  else
    s8_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(A, Bt, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int awr_s8_deconv(const int8_t* x, const int8_t* wph,
                             const float* scale, float* out, int B, int H,
                             int W, int Cin, int Cout, cudaStream_t stream) {
  const int tiles = (B * H * W + kBM - 1) / kBM;
  const dim3 grid(4 * tiles, (Cout + kBN - 1) / kBN);
  s8_deconv_kernel<<<grid, kThreads, 0, stream>>>(x, wph, scale, out, B, H, W,
                                                  Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
