// AWR adaptive weighted decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel awr_tpu/ops/pallas_decode.py:_decode_kernel
// (launched by decode_pallas). Same function as the plain PyTorch
// awr_tpu_torch/ops/functional.py:offset2joint_softmax:
//
//   mask   = nearest_resize(img) < 0.99            (per pixel)
//   ht     = heatmap * mask
//   w      = softmax_p(30 * ht)                    (per joint, over F*F pixels)
//   out[j] = sum_p w * (vec * mask * (k - k * ht) + (x, y, depth_raw))
//
// Inputs: offset (B, 4J, F, F) float32 or bfloat16, NCHW, contiguous (each
// joint's heatmap and three offset planes are contiguous F*F runs, so the
// loads below are coalesced); img (B, H, W) float32. Output (B, J, 3) float32.
//
// Bound: HBM reads. The map is the whole payload: 4 bytes * F^2 * 4J plus
// the F^2 resized depth pixels, about 0.93 MB a sample at F = 64, J = 14,
// so about 30 MB at B = 32: about 9 us at the 3.35 TB/s of an H100 SXM. The
// arithmetic is about 20 float operations per (sample, joint, pixel), two
// orders of magnitude under the card's float32 rate at that byte count.
//
// Design: one block of 256 threads per (sample, joint), grid (B, J), which
// is 448 blocks at B = 32 on 132 SMs. Pass 1 reads the joint's heatmap
// plane and block-reduces the softmax max; pass 2 reads the heatmap again
// (16 KB a block, served from L2) with the three offset planes and
// accumulates the seven sums (sum e, three offset sums, three coordinate
// sums), block-reduced and divided by sum e once. So the map leaves HBM
// once; the nearest resize of the depth is fused into the index arithmetic
// and its F^2 pixels are re-read from L2 by the J blocks of a sample.
//
// Decode backward (decode_backward_kernel below). Replaces the XLA VJP of
// the jnp decode that the JAX package's custom_vjp recomputes through
// (awr_tpu/ops/decode.py:_bwd), not a Pallas kernel. Same function as
// awr_tpu_torch/ops/functional.py:offset2joint_softmax_backward. With
// m = mask, h = ht * m, w = softmax(30 h), dis = k - k h, v = vec * m,
// c = (x, y, depth_raw) and g = dL/dout[b, j]:
//
//   dL/dvec_p[a] = m g_a w_p dis_p
//   dL/dht_p     = m w_p (-k g.v_p + 30 (g.(v_p dis_p + c_p) - g.out))
//
// written as a (B, 4J, F, F) gradient in the map's dtype; background
// pixels get 0. Bound: HBM, the map read once and its gradient written
// once, 29.4 MB each way at B = 32, F = 64, J = 14 (float32): about
// 17.5 us at 3.35 TB/s. Design: the forward's grid (B, J) and 256
// threads. Passes 1 and 2 recompute the softmax max and sum from the
// heatmap plane (the second read comes from L2); `out` is the forward's
// saved output; pass 3 reads the four planes and writes the four
// gradient planes, coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFgThreshold = 0.99f;
constexpr float kSoftmaxTemp = 30.0f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pixel-center coordinate 2 * (i + 0.5) / F - 1, evaluated in double and
// rounded once, as the plain version's float64 mesh is.
__device__ __forceinline__ float mesh(int i, int F) {
  return static_cast<float>(2.0 * (i + 0.5) / F - 1.0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ offset, const float* __restrict__ img,
                  float* __restrict__ out, int J, int F, int H, int W,
                  float k) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int P = F * F;
  const T* sample = offset + static_cast<size_t>(b) * 4 * J * P;
  const T* ht_plane = sample + static_cast<size_t>(3 * J + j) * P;
  const T* vx_plane = sample + static_cast<size_t>(3 * j) * P;
  const T* vy_plane = vx_plane + P;
  const T* vd_plane = vy_plane + P;
  const float* depth = img + static_cast<size_t>(b) * H * W;

  __shared__ float partial[7][kWarps];
  __shared__ float block_max;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Pass 1: max over pixels of the masked logit.
  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / F;
    const int x = p - y * F;
    const float d = depth[static_cast<size_t>((y * H) / F) * W + (x * W) / F];
    const float mask = d < kFgThreshold ? 1.0f : 0.0f;
    const float ht = to_float(ht_plane[p]) * mask;
    m = fmaxf(m, ht * kSoftmaxTemp);
  }
  m = warp_max(m);
  if (lane == 0) partial[0][warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = partial[0][0];
    for (int i = 1; i < kWarps; ++i) v = fmaxf(v, partial[0][i]);
    block_max = v;
  }
  __syncthreads();
  m = block_max;

  // Pass 2: unnormalized weighted sums.
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / F;
    const int x = p - y * F;
    const float d = depth[static_cast<size_t>((y * H) / F) * W + (x * W) / F];
    const float mask = d < kFgThreshold ? 1.0f : 0.0f;
    const float ht = to_float(ht_plane[p]) * mask;
    const float e = expf(ht * kSoftmaxTemp - m);
    const float ed = e * (k - ht * k);
    acc[0] += e;
    acc[1] += to_float(vx_plane[p]) * mask * ed;
    acc[2] += to_float(vy_plane[p]) * mask * ed;
    acc[3] += to_float(vd_plane[p]) * mask * ed;
    acc[4] += e * mesh(x, F);
    acc[5] += e * mesh(y, F);
    acc[6] += e * d;
  }
  __syncthreads();  // partial[0] is reused below
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) partial[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float s = 0.f, vec = 0.f, coord = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      s += partial[0][i];
      vec += partial[1 + a][i];
      coord += partial[4 + a][i];
    }
    out[(static_cast<size_t>(b) * J + j) * 3 + a] = vec / s + coord / s;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Block-wide max and sum over kThreads threads; `scratch` holds kWarps
// floats and is free again on return.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, scratch[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < kWarps; ++i) r += scratch[i];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_backward_kernel(const T* __restrict__ offset,
                           const float* __restrict__ img,
                           const float* __restrict__ out,
                           const float* __restrict__ grad_out,
                           T* __restrict__ grad, int J, int F, int H, int W,
                           float k) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int P = F * F;
  const size_t ht_off = (static_cast<size_t>(b) * 4 * J + 3 * J + j) * P;
  const size_t vx_off = (static_cast<size_t>(b) * 4 * J + 3 * j) * P;
  const float* depth = img + static_cast<size_t>(b) * H * W;
  __shared__ float scratch[kWarps];

  // Pass 1: max over pixels of the masked logit.
  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / F;
    const int x = p - y * F;
    const float d = depth[static_cast<size_t>((y * H) / F) * W + (x * W) / F];
    const float mask = d < kFgThreshold ? 1.0f : 0.0f;
    m = fmaxf(m, to_float(offset[ht_off + p]) * mask * kSoftmaxTemp);
  }
  m = block_max(m, scratch);

  // Pass 2: the softmax denominator.
  float s = 0.f;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / F;
    const int x = p - y * F;
    const float d = depth[static_cast<size_t>((y * H) / F) * W + (x * W) / F];
    const float mask = d < kFgThreshold ? 1.0f : 0.0f;
    s += expf(to_float(offset[ht_off + p]) * mask * kSoftmaxTemp - m);
  }
  s = block_sum(s, scratch);

  const float* gj = grad_out + (static_cast<size_t>(b) * J + j) * 3;
  const float* oj = out + (static_cast<size_t>(b) * J + j) * 3;
  const float gx = gj[0], gy = gj[1], gd = gj[2];
  const float g_out = gx * oj[0] + gy * oj[1] + gd * oj[2];

  // Pass 3: the four gradient planes.
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / F;
    const int x = p - y * F;
    const float d = depth[static_cast<size_t>((y * H) / F) * W + (x * W) / F];
    const float mask = d < kFgThreshold ? 1.0f : 0.0f;
    const float ht = to_float(offset[ht_off + p]) * mask;
    const float w = expf(ht * kSoftmaxTemp - m) / s;
    const float dis = k - ht * k;
    const float vx = to_float(offset[vx_off + p]) * mask;
    const float vy = to_float(offset[vx_off + P + p]) * mask;
    const float vd = to_float(offset[vx_off + 2 * P + p]) * mask;
    const float g_v = gx * vx + gy * vy + gd * vd;
    const float g_term = gx * (vx * dis + mesh(x, F)) +
                         gy * (vy * dis + mesh(y, F)) + gd * (vd * dis + d);
    const float wd = w * dis * mask;
    store(grad + vx_off + p, gx * wd);
    store(grad + vx_off + P + p, gy * wd);
    store(grad + vx_off + 2 * P + p, gd * wd);
    store(grad + ht_off + p,
          mask * w * (-k * g_v + kSoftmaxTemp * (g_term - g_out)));
  }
}

template <typename T>
int launch_backward(const void* offset, const float* img, const float* out,
                    const float* grad_out, void* grad, int B, int J, int F,
                    int H, int W, float k, cudaStream_t stream) {
  const dim3 grid(B, J);
  decode_backward_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(offset), img, out, grad_out, static_cast<T*>(grad),
      J, F, H, W, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* offset, const float* img, float* out, int B, int J,
           int F, int H, int W, float k, cudaStream_t stream) {
  const dim3 grid(B, J);
  decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(offset), img, out, J, F, H, W, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launchers: enqueue on `stream`, never synchronize, return
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int awr_decode_f32(const void* offset, const float* img,
                              float* out, int B, int J, int F, int H, int W,
                              float k, cudaStream_t stream) {
  return launch<float>(offset, img, out, B, J, F, H, W, k, stream);
}

extern "C" int awr_decode_bf16(const void* offset, const float* img,
                               float* out, int B, int J, int F, int H, int W,
                               float k, cudaStream_t stream) {
  return launch<__nv_bfloat16>(offset, img, out, B, J, F, H, W, k, stream);
}

extern "C" int awr_decode_backward_f32(const void* offset, const float* img,
                                       const float* out,
                                       const float* grad_out, void* grad,
                                       int B, int J, int F, int H, int W,
                                       float k, cudaStream_t stream) {
  return launch_backward<float>(offset, img, out, grad_out, grad, B, J, F, H,
                                W, k, stream);
}

extern "C" int awr_decode_backward_bf16(const void* offset, const float* img,
                                        const float* out,
                                        const float* grad_out, void* grad,
                                        int B, int J, int F, int H, int W,
                                        float k, cudaStream_t stream) {
  return launch_backward<__nv_bfloat16>(offset, img, out, grad_out, grad, B,
                                        J, F, H, W, k, stream);
}
