// The bf16 inference form's own kernels (awr_tpu_torch/models/inference.py),
// for Hopper (sm_90a): the passes between its cuDNN convs, on channels-last
// (NHWC) bf16 tensors, with float32 arithmetic and one rounding each.
// Plain versions: awr_tpu_torch/ops/folded.py.
//
// They replace no TPU kernel: on the TPU, XLA fuses the BatchNorm, bias,
// residual, ReLU and max-pool into the convs of the JAX package's jitted
// forward. Here cuDNN's precompiled convs take no epilogue, and its
// runtime-fused plans (conv + bias + add + ReLU) compile at their first
// call, about 13 s for resnet_18's shapes, and ran no faster on the H100.
//
// bias_relu: y = relu(y + bias[c] + z) in place on a bf16 tensor seen as
// (M, C) rows of C channels, z (the same layout) or none: a conv's bias
// from its folded BatchNorm, a block's residual, the ReLU. Bound: bytes,
// one read and one write of y and one read of z: 1.07 GB at the last
// deconv of resnet_18 at B = 256 (256 channels, 64 x 64, no z), 0.32 ms at
// 3.35 TB/s. Design: 8 channels (16 bytes) a thread a step, grid-stride;
// C % 8 == 0, so a thread's 8 channels are consecutive ones of one pixel.
//
// head_out: the heads' (B, P, C) bf16 output (P = H * W) -> (B, C, P)
// float32 + bias[c], the NCHW map the decode reads. Bound: bytes, 2 read +
// 4 written a value: 352 MB at B = 256 (C = 56, P = 4096), 0.105 ms.
// Design: a block a (sample, tile of kTile pixels); the tile's kTile * C
// inputs are one contiguous run, read coalesced into shared memory as
// float (a row of kTile + 1 floats a channel, so the transposed reads hit
// distinct banks), then each channel's kTile outputs written as one
// coalesced run.
//
// stem_pool: the ResNet stem, a 5x5 conv (pad 2) of the one-channel float32
// depth rounded to bf16, into 64 channels, + bias, ReLU, rounded to bf16,
// then the 3x3 / stride 2 / pad 1 max-pool: (B, H, W) -> (B, ceil(H/2),
// ceil(W/2), 64). Bound: bytes, 16.8 MB read and 134 MB written at
// B = 256, H = W = 128, 0.045 ms at 3.35 TB/s. Its 6.7 G multiply-adds
// (25 a conv output) take bf16 operands and float32 sums, which the bf16
// tensor cores compute at 989 TFLOP/s, 0.014 ms; this kernel runs them on
// the float32 cores (33.5 T FMA/s, 0.2 ms), a limit of its design and not
// of the card. cuDNN ran this conv at 2.1 ms (its 8-channel channels-last plan, the
// input zero-padded) and the max-pool at 1.07 ms, writing and reading the
// 537 MB conv output between them. Design: a block a tile of kPoolTH x
// kPoolTW pooled pixels; it computes the (2 kPoolTH + 1) x (2 kPoolTW + 1)
// conv pixels under them (1.10x the conv's work for the overlap) into
// shared memory as bf16 and pools from there, so the conv output never
// reaches device memory. A thread holds one conv pixel's 25 inputs in
// registers and sums 8 channels at a time; the weights, [tap][channel] in
// shared memory, are broadcast reads. Conv pixels outside the image are
// stored as 0: every pool window holds a pixel of the image, and the ReLU
// makes those >= 0, so the max is the -inf-padded one. The conv tile's
// 16-byte chunks are XOR-swizzled by pixel, so a quarter-warp's stores of
// 8 pixels' chunk k land in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;    // bf16 values a thread a step of bias_relu
constexpr int kTile = 64;  // pixels a block of head_out

constexpr int kStemC = 64;                       // stem output channels
constexpr int kStemK = 5;                        // 5 x 5 taps, pad 2
constexpr int kTaps = kStemK * kStemK;
constexpr int kChunks = kStemC / 8;              // 16-byte chunks a pixel
constexpr int kPoolTH = 8;                       // pooled rows a block
constexpr int kPoolTW = 16;                      // pooled columns a block
constexpr int kConvH = 2 * kPoolTH + 1;          // 17 conv rows
constexpr int kConvW = 2 * kPoolTW + 1;          // 33 conv columns
constexpr int kInH = kConvH + kStemK - 1;        // 21 input rows
constexpr int kInW = kConvW + kStemK - 1;        // 37 input columns
constexpr int kStemThreads = 288;                // 561 conv pixels: 2 rounds
constexpr size_t kConvSmem =
    sizeof(uint4) * kConvH * kConvW * kChunks;   // 71,808 bytes

__global__ void bias_relu_kernel(__nv_bfloat16* __restrict__ y,
                                 const float* __restrict__ bias,
                                 const __nv_bfloat16* __restrict__ z,
                                 long long n_vec, int C) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n_vec; i += static_cast<long long>(gridDim.x) * kThreads) {
    uint4 v = reinterpret_cast<uint4*>(y)[i];
    uint4 r = z == nullptr ? make_uint4(0, 0, 0, 0)
                           : reinterpret_cast<const uint4*>(z)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* hr = reinterpret_cast<const __nv_bfloat162*>(&r);
    const int c = static_cast<int>((i * kVec) % C);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      f.x += __ldg(bias + c + 2 * k);
      f.y += __ldg(bias + c + 2 * k + 1);
      if (z != nullptr) {
        const float2 fr = __bfloat1622float2(hr[k]);
        f.x += fr.x;
        f.y += fr.y;
      }
      // NaN < 0 is false: a NaN stays NaN, as torch.relu keeps it
      f.x = f.x < 0.f ? 0.f : f.x;
      f.y = f.y < 0.f ? 0.f : f.y;
      h[k] = __floats2bfloat162_rn(f.x, f.y);
    }
    reinterpret_cast<uint4*>(y)[i] = v;
  }
}

__global__ void head_out_kernel(const __nv_bfloat16* __restrict__ y,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int P, int C) {
  extern __shared__ float tile[];  // [C][kTile + 1]
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, P - p0);
  const __nv_bfloat16* src = y + (static_cast<long long>(b) * P + p0) * C;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int p = i / C, c = i - p * C;
    tile[c * (kTile + 1) + p] = __bfloat162float(src[i]) + __ldg(bias + c);
  }
  __syncthreads();
  float* dst = out + static_cast<long long>(b) * C * P + p0;
  for (int i = threadIdx.x; i < C * kTile; i += kThreads) {
    const int c = i / kTile, p = i - c * kTile;
    if (p < n) dst[static_cast<long long>(c) * P + p] =
        tile[c * (kTile + 1) + p];
  }
}

__device__ __forceinline__ uint32_t pack_relu(float a, float b) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(a < 0.f ? 0.f : a, b < 0.f ? 0.f : b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(kStemThreads)
    stem_pool_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W, int Hp,
                     int Wp) {
  __shared__ float s_in[kInH * kInW];
  __shared__ float4 s_w[kTaps * kStemC / 4];  // [tap][channel]
  __shared__ float4 s_b[kStemC / 4];
  extern __shared__ uint4 s_conv[];           // [conv pixel][chunk ^ swz]
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kPoolTH, px0 = blockIdx.x * kPoolTW;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // the tile's conv origin
  const float* xb = x + static_cast<long long>(b) * H * W;
  for (int i = threadIdx.x; i < kInH * kInW; i += kStemThreads) {
    const int r = i / kInW, c = i - r * kInW;
    const int gy = cy0 - 2 + r, gx = cx0 - 2 + c;
    const float v = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? xb[static_cast<long long>(gy) * W + gx]
                        : 0.f;
    s_in[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  for (int i = threadIdx.x; i < kTaps * kStemC; i += kStemThreads) {
    const int t = i / kStemC, c = i - t * kStemC;
    reinterpret_cast<float*>(s_w)[i] = __bfloat162float(w[c * kTaps + t]);
  }
  if (threadIdx.x < kStemC) {
    reinterpret_cast<float*>(s_b)[threadIdx.x] = bias[threadIdx.x];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < kConvH * kConvW; p += kStemThreads) {
    const int r = p / kConvW, c = p - r * kConvW;
    const int gy = cy0 + r, gx = cx0 + c;
    uint4* dst = s_conv + p * kChunks;
    const int swz = p & (kChunks - 1);
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) dst[k] = make_uint4(0, 0, 0, 0);
      continue;
    }
    float in[kTaps];
#pragma unroll
    for (int ky = 0; ky < kStemK; ++ky) {
#pragma unroll
      for (int kx = 0; kx < kStemK; ++kx) {
        in[ky * kStemK + kx] = s_in[(r + ky) * kInW + c + kx];
      }
    }
#pragma unroll 1
    for (int k = 0; k < kChunks; ++k) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const float4 w0 = s_w[t * (kStemC / 4) + 2 * k];
        const float4 w1 = s_w[t * (kStemC / 4) + 2 * k + 1];
        acc[0] = fmaf(w0.x, in[t], acc[0]);
        acc[1] = fmaf(w0.y, in[t], acc[1]);
        acc[2] = fmaf(w0.z, in[t], acc[2]);
        acc[3] = fmaf(w0.w, in[t], acc[3]);
        acc[4] = fmaf(w1.x, in[t], acc[4]);
        acc[5] = fmaf(w1.y, in[t], acc[5]);
        acc[6] = fmaf(w1.z, in[t], acc[6]);
        acc[7] = fmaf(w1.w, in[t], acc[7]);
      }
      const float4 b0 = s_b[2 * k], b1 = s_b[2 * k + 1];
      dst[k ^ swz] = make_uint4(pack_relu(acc[0] + b0.x, acc[1] + b0.y),
                                pack_relu(acc[2] + b0.z, acc[3] + b0.w),
                                pack_relu(acc[4] + b1.x, acc[5] + b1.y),
                                pack_relu(acc[6] + b1.z, acc[7] + b1.w));
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kPoolTH * kPoolTW * kChunks;
       i += kStemThreads) {
    const int k = i % kChunks, q = i / kChunks;
    const int pr = q / kPoolTW, pc = q - pr * kPoolTW;
    const int gy = py0 + pr, gx = px0 + pc;
    if (gy >= Hp || gx >= Wp) continue;
    __nv_bfloat162 m[4];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int cp = (2 * pr + dy) * kConvW + 2 * pc + dx;
        uint4 v = s_conv[cp * kChunks + (k ^ (cp & (kChunks - 1)))];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = (dy == 0 && dx == 0) ? h[j] : __hmax2_nan(m[j], h[j]);
        }
      }
    }
    uint4 o;
    uint32_t* ou = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) ou[j] = *reinterpret_cast<uint32_t*>(&m[j]);
    reinterpret_cast<uint4*>(out)[
        ((static_cast<long long>(b) * Hp + gy) * Wp + gx) * kChunks + k] = o;
  }
}

}  // namespace

extern "C" int awr_bias_relu_bf16(void* y, const float* bias,
                                  const void* z, long long numel, int C,
                                  int sms, cudaStream_t stream) {
  const long long n_vec = numel / kVec;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  // enough blocks to fill every SM several times over; the rest loop
  const int grid = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  bias_relu_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<__nv_bfloat16*>(y), bias,
      static_cast<const __nv_bfloat16*>(z), n_vec, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int awr_head_out_bf16(const void* y, const float* bias,
                                 float* out, int B, int P, int C,
                                 cudaStream_t stream) {
  const dim3 grid((P + kTile - 1) / kTile, B);
  const size_t smem = sizeof(float) * C * (kTile + 1);
  head_out_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y), bias, out, P, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int awr_stem_pool_bf16(const float* x, const void* w,
                                  const float* bias, void* out, int B, int H,
                                  int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kConvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = (H + 1) / 2, Wp = (W + 1) / 2;
  const dim3 grid((Wp + kPoolTW - 1) / kPoolTW, (Hp + kPoolTH - 1) / kPoolTH,
                  B);
  stem_pool_kernel<<<grid, kStemThreads, kConvSmem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), H, W, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}
