// AWR encode (joints -> dense GT offset field) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel awr_tpu/ops/pallas_encode.py:_encode_kernel
// (launched by encode_pallas). Same function as the plain PyTorch
// awr_tpu_torch/ops/functional.py:joint2offset. Per sample b, pixel
// p = (y, x) and joint j:
//
//   d    = nearest_resize(img)[y, x]
//   off  = joint_j - (mesh(x), mesh(y), d)
//   dis  = sqrt(|off|^2 + 1e-8)
//   ht   = (k - dis) / k
//   mask = (ht >= 0) & (d < 0.99)
//   out[b, 3j+a, y, x] = off_a / dis * mask ; out[b, 3J+j, y, x] = ht * mask
//
// Inputs: jt (B, J, 3) float32, img (B, H, W) float32, both contiguous.
// Output (B, 4J, F, F) float32, NCHW.
//
// Bound: the HBM store. 4 bytes * 4J * F^2 a sample is 29.4 MB at B = 32,
// F = 64, J = 14, plus about 1 MB of depth read: about 9 us at the
// 3.35 TB/s of an H100 SXM. About 20 float operations per (b, j, p) come to
// 37 MFLOP, far under the card's float32 rate.
//
// Design: one thread a pixel, 256 pixels a block, grid (ceil(F^2/256), B):
// 512 blocks at B = 32. The sample's J joints sit in shared memory; each
// thread reads its depth pixel once (the nearest resize fused into the
// index arithmetic) and loops over j, so each of the 4J output planes is
// written coalesced, 1 KB a warp-row. The sums and products use the _rn
// intrinsics so nvcc cannot contract them into FMAs: the mask tests the
// rounded ht, and a contracted sum would move boundary pixels against the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFgThreshold = 0.99f;
constexpr float kDisEps = 1e-8f;

// Pixel-center coordinate 2 * (i + 0.5) / F - 1, evaluated in double and
// rounded once, as the plain version's float64 mesh is.
__device__ __forceinline__ float mesh(int i, int F) {
  return static_cast<float>(2.0 * (i + 0.5) / F - 1.0);
}

__global__ void __launch_bounds__(kThreads)
    encode_kernel(const float* __restrict__ jt, const float* __restrict__ img,
                  float* __restrict__ out, int J, int F, int H, int W,
                  float k) {
  extern __shared__ float joints[];  // 3J floats of sample b
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * J; i += kThreads)
    joints[i] = jt[static_cast<size_t>(b) * 3 * J + i];
  __syncthreads();

  const int P = F * F;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int y = p / F;
  const int x = p - y * F;
  const float d = img[static_cast<size_t>(b) * H * W +
                      static_cast<size_t>((y * H) / F) * W + (x * W) / F];
  const float mx = mesh(x, F);
  const float my = mesh(y, F);
  const bool fg = d < kFgThreshold;
  float* o = out + static_cast<size_t>(b) * 4 * J * P + p;
  for (int j = 0; j < J; ++j) {
    const float dx = __fsub_rn(joints[3 * j], mx);
    const float dy = __fsub_rn(joints[3 * j + 1], my);
    const float dz = __fsub_rn(joints[3 * j + 2], d);
    const float sq = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz)),
        kDisEps);
    const float dis = __fsqrt_rn(sq);
    const float ht = __fdiv_rn(__fsub_rn(k, dis), k);
    const float mask = (ht >= 0.0f && fg) ? 1.0f : 0.0f;
    o[static_cast<size_t>(3 * j) * P] = __fmul_rn(__fdiv_rn(dx, dis), mask);
    o[static_cast<size_t>(3 * j + 1) * P] = __fmul_rn(__fdiv_rn(dy, dis), mask);
    o[static_cast<size_t>(3 * j + 2) * P] = __fmul_rn(__fdiv_rn(dz, dis), mask);
    o[static_cast<size_t>(3 * J + j) * P] = __fmul_rn(ht, mask);
  }
}

}  // namespace

// Launcher: enqueues on `stream`, never synchronizes, returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int awr_encode_f32(const float* jt, const float* img, float* out,
                              int B, int J, int F, int H, int W, float k,
                              cudaStream_t stream) {
  const dim3 grid((F * F + kThreads - 1) / kThreads, B);
  const size_t smem = sizeof(float) * 3 * J;
  encode_kernel<<<grid, kThreads, smem, stream>>>(jt, img, out, J, F, H, W,
                                                  k);
  return static_cast<int>(cudaGetLastError());
}
