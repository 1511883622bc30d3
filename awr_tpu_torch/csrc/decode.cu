// AWR adaptive weighted decode and its backward for Hopper (sm_90a).
//
// decode_kernel replaces the Pallas TPU kernel
// awr_tpu/ops/pallas_decode.py:_decode_kernel (launched by decode_pallas).
// Same function as the plain PyTorch
// awr_tpu_torch/ops/functional.py:offset2joint_softmax, plus the softmax
// statistics of offset2joint_softmax_stats:
//
//   mask   = nearest_resize(img) < 0.99            (per pixel)
//   ht     = heatmap * mask
//   l      = ht * 30                               (the masked logit)
//   m      = max_p l,  s = sum_p exp(l - m)        (per joint: the stats)
//   w      = exp(l - m) / s
//   out[j] = sum_p w * (vec * mask * (k - k * ht) + (x, y, depth_raw))
//
// Inputs: offset (B, 4J, F, F) float32 or bfloat16, NCHW, contiguous (each
// joint's heatmap and three offset planes are contiguous F*F runs); img
// (B, H, W) float32. Outputs: out (B, J, 3) float32 and stats (B, J, 2)
// float32, (m, s) of each joint.
//
// Row window (spatial serving, awr_tpu_torch/parallel/spatial.py): the
// same kernel decodes rows [row0, row0 + rows) of an F x F map given as a
// (B, 4J, rows, F) tensor, with the depth rows [img_row0, img_row0 + img_h)
// of the (B, H, W) depth that the window's nearest resize reads. The sums
// and (m, s) are then the window's: the plain
// offset2joint_softmax_rows, merged across windows by
// merge_softmax_bands. Pixel coordinates and source rows are those of
// the global row. The full map is row0 = 0, rows = F, img_row0 = 0,
// img_h = H.
//
// Bound: HBM reads. The map is the payload: 4 bytes * F^2 * 4J plus the
// F^2 resized depth pixels, about 0.93 MB a sample at F = 64, J = 14 in
// float32, so about 30 MB at B = 32: 8.9 us at the 3.35 TB/s of an H100
// SXM. About 25 float operations per (sample, joint, pixel), two orders of
// magnitude under the card's float32 rate at that byte count.
//
// Design. One block of 256 threads for each (sample, joint), grid B * J.
// One pass: a thread loads 4 consecutive pixels of a row from each of the
// four planes (16-byte loads in float32, 8-byte in bfloat16; scalar loads
// where F % 4 != 0), two such groups issued before either is used, and
// folds them into an online softmax: a running max m and, scaled to it,
// the sum s and the six weighted sums (three offset, three coordinate),
// rescaled by exp(m_old - m_new) when a group raises m. So each plane
// leaves HBM once, with no barrier between the max and the sums (an
// online softmax rather than logits kept in registers or shared memory:
// a heatmap plane is 64 KB at F = 128). The partials merge by the same
// rescale rule across the warp and then the block; thread 0 writes the
// joint and its (m, s). The max is order-free, so m is bit-equal to the
// plain version's. Splitting a joint over a thread-block cluster merged
// through distributed shared memory was measured and dropped: every block
// costs latency of its own, so a cluster lost from B = 4 up and gained a
// few per cent only at B = 1, below the smallest serving bucket (PERF.md).
//
// The pixel loop does no division: a prologue builds three shared-memory
// tables a block, the source-row offsets ((y H) / F - img_row0) W of its
// rows and the F source columns (x W) / F of the nearest resize, and the
// F pixel-centre coordinates 2 (i + 0.5) / F - 1, evaluated in double and
// rounded once as the plain version's float64 mesh is (so bit-equal to
// it). A thread walks its pixel groups with a (row, column) cursor
// advanced by additions.
//
// decode_backward_kernel replaces the XLA VJP of the jnp decode that the
// JAX package's custom_vjp recomputes through (awr_tpu/ops/decode.py:_bwd),
// not a Pallas kernel. Same function as
// awr_tpu_torch/ops/functional.py:offset2joint_softmax_backward given the
// stats. With w from the forward's saved (m, s), dis = k - k ht,
// v = vec * mask, c = (x, y, depth_raw) and g = dL/dout[b, j]:
//
//   dL/dvec_p[a] = mask g_a w_p dis_p
//   dL/dht_p     = mask w_p (-k g.v_p + 30 (g.(v_p dis_p + c_p) - g.out))
//
// written as a (B, 4J, F, F) gradient in the map's dtype; background pixels
// get exactly 0. Bound: HBM, the map read once and its gradient written
// once, 29.4 MB each way at B = 32, F = 64, J = 14 (float32): 17.7 us at
// 3.35 TB/s. Design: with the stats saved, the backward is an elementwise
// map. Grid B * J: a block takes the four planes of one (sample, joint)
// (smaller row chunks a block were measured slower at B = 32), reads
// (m, s), g and out for that joint, and writes the four gradient planes
// with the forward's tables, cursor and 16-byte loads and stores. No
// reduction is left, and the softmax max and sum are never recomputed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pixel groups a thread loads before it uses any of them
constexpr int kUnroll = 2;
constexpr float kFgThreshold = 0.99f;
constexpr float kSoftmaxTemp = 30.0f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive map elements as float32: one 16-byte (float32) or 8-byte
// (bfloat16) streaming load for V = 4.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[4]) {
  // little-endian: element 2i is the low half of word i; a bfloat16 is
  // the top 16 bits of the float32 it widens to
  const uint2 r = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) {
  v[0] = to_float(*p);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), r);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
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

// The nearest-resize and pixel-centre tables of one block, in dynamic
// shared memory: mesh[F] float, col[F] int, row[rows] int ((2 F + rows) *
// 4 bytes). mesh and col are indexed by the map's column (and mesh_y by
// the window's row: mesh + row0), row by the window's row: the offset of
// the depth row that the global row row0 + i reads, in the depth rows
// given from img_row0. For V = 4, F % 4 == 0, so col is 16-byte aligned.
struct Tables {
  const float* mesh;
  const float* mesh_y;
  const int* col;
  const int* row;
};

__device__ __forceinline__ Tables build_tables(int F, int rows, int row0,
                                               int H, int W, int img_row0) {
  extern __shared__ float4 smem[];
  float* mesh = reinterpret_cast<float*>(smem);
  int* col = reinterpret_cast<int*>(mesh + F);
  int* row = col + F;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    // pixel-centre coordinate 2 (i + 0.5) / F - 1 in double, rounded once
    mesh[i] = static_cast<float>(2.0 * (i + 0.5) / F - 1.0);
    col[i] = (i * W) / F;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    row[i] = (((row0 + i) * H) / F - img_row0) * W;
  __syncthreads();
  return Tables{mesh, mesh + row0, col, row};
}

// A thread's place in its block's plane of F columns (F x F, or a window
// of rows x F): it takes every kThreads-th group of V pixels, row by row;
// `step` moves to the next without dividing.
template <int V>
struct Cursor {
  int y, x, dy, dx;
  __device__ __forceinline__ explicit Cursor(int F) {
    const int groups = F / V;  // groups a row
    y = threadIdx.x / groups;
    x = (threadIdx.x % groups) * V;
    dy = kThreads / groups;
    dx = (kThreads % groups) * V;
  }
  __device__ __forceinline__ void step(int F) {
    x += dx;
    y += dy;
    if (x >= F) {
      x -= F;
      ++y;
    }
  }
};

// One group of V pixels, loaded: the heatmap, the three offsets, the raw
// depth and the two coordinates.
template <int V>
struct Group {
  float h[V], vx[V], vy[V], vd[V], d[V], cx[V];
  float cy;
};

template <int V, typename T>
__device__ __forceinline__ void load_group(Group<V>& g, const T* ht,
                                           const T* vx, size_t P,
                                           const float* depth,
                                           const Tables& tb, int F, int y,
                                           int x) {
  const int p = y * F + x;
  load_vec(ht + p, g.h);
  load_vec(vx + p, g.vx);
  load_vec(vx + P + p, g.vy);
  load_vec(vx + 2 * P + p, g.vd);
  const float* drow = depth + tb.row[y];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    g.d[i] = __ldg(drow + tb.col[x + i]);
    g.cx[i] = tb.mesh[x + i];
  }
  g.cy = tb.mesh_y[y];
}

// Online-softmax partial: the max m of the logits seen and, scaled to
// exp(-m), their sum s and the six weighted sums (three offset terms,
// then the x, y and depth coordinates).
struct Partial {
  float m, s, a[6];
};

__device__ __forceinline__ Partial empty_partial() {
  return Partial{-INFINITY, 0.f, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
}

// exp(m - to), the factor that rescales a partial of max m to max `to`;
// 0 for an empty partial (m = -inf), even when `to` is -inf too.
__device__ __forceinline__ float rescale(float m, float to) {
  return m == -INFINITY ? 0.f : expf(m - to);
}

template <int V>
__device__ __forceinline__ void accumulate(Partial& q, const Group<V>& g,
                                           float k) {
  float mask[V], ht[V], l[V];
  float gm = -INFINITY;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mask[i] = g.d[i] < kFgThreshold ? 1.0f : 0.0f;
    ht[i] = g.h[i] * mask[i];
    l[i] = ht[i] * kSoftmaxTemp;  // spelled as the plain version's
    gm = fmaxf(gm, l[i]);
  }
  if (gm > q.m) {
    const float f = rescale(q.m, gm);
    q.s *= f;
#pragma unroll
    for (int a = 0; a < 6; ++a) q.a[a] *= f;
    q.m = gm;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float e = expf(l[i] - q.m);
    const float ed = e * (k - ht[i] * k);
    q.s += e;
    q.a[0] += g.vx[i] * mask[i] * ed;
    q.a[1] += g.vy[i] * mask[i] * ed;
    q.a[2] += g.vd[i] * mask[i] * ed;
    q.a[3] += e * g.cx[i];
    q.a[4] += e * g.cy;
    q.a[5] += e * g.d[i];
  }
}

// Merges the partials of a warp's lanes; every lane gets the result.
__device__ __forceinline__ void warp_merge(Partial& q) {
  const float m = warp_max(q.m);
  const float f = rescale(q.m, m);
  q.s = warp_sum(q.s * f);
#pragma unroll
  for (int a = 0; a < 6; ++a) q.a[a] = warp_sum(q.a[a] * f);
  q.m = m;
}

__device__ __forceinline__ void put(float* dst, const Partial& q) {
  dst[0] = q.m;
  dst[1] = q.s;
#pragma unroll
  for (int a = 0; a < 6; ++a) dst[2 + a] = q.a[a];
}

__device__ __forceinline__ Partial get(const float* src) {
  Partial q;
  q.m = src[0];
  q.s = src[1];
#pragma unroll
  for (int a = 0; a < 6; ++a) q.a[a] = src[2 + a];
  return q;
}

// Grid B * J; dynamic shared memory (2 F + rows) * 4 bytes. The window's
// map is (B, 4J, rows, F); its depth (B, img_h, W), rows [img_row0,
// img_row0 + img_h) of the (B, H, W) depth.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ offset, const float* __restrict__ img,
                  float* __restrict__ out, float* __restrict__ stats, int J,
                  int F, int rows, int row0, int H, int W, int img_row0,
                  int img_h, float k) {
  const int bj = blockIdx.x;
  const int b = bj / J;
  const int j = bj - b * J;
  const size_t P = static_cast<size_t>(rows) * F;
  const T* sample = offset + static_cast<size_t>(b) * 4 * J * P;
  const T* ht = sample + (3 * J + j) * P;
  const T* vx = sample + 3 * j * P;
  const float* depth = img + static_cast<size_t>(b) * img_h * W;
  const Tables tb = build_tables(F, rows, row0, H, W, img_row0);

  Cursor<V> cur(F);
  Partial q = empty_partial();
  while (cur.y < rows) {
    Group<V> g[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      live[u] = cur.y < rows;
      if (live[u]) load_group(g[u], ht, vx, P, depth, tb, F, cur.y, cur.x);
      cur.step(F);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (live[u]) accumulate(q, g[u], k);
  }

  // warps, then the block's warps in warp 0
  __shared__ float warp_part[kWarps][8];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  warp_merge(q);
  if (lane == 0) put(warp_part[warp], q);
  __syncthreads();
  if (warp == 0) {
    q = lane < kWarps ? get(warp_part[lane]) : empty_partial();
    warp_merge(q);
  }
  if (threadIdx.x == 0) {
    float* o = out + static_cast<size_t>(bj) * 3;
    o[0] = q.a[0] / q.s + q.a[3] / q.s;
    o[1] = q.a[1] / q.s + q.a[4] / q.s;
    o[2] = q.a[2] / q.s + q.a[5] / q.s;
    stats[2 * static_cast<size_t>(bj)] = q.m;
    stats[2 * static_cast<size_t>(bj) + 1] = q.s;
  }
}

// Grid B * J; dynamic shared memory 12 F bytes (the full map's tables).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    decode_backward_kernel(const T* __restrict__ offset,
                           const float* __restrict__ img,
                           const float* __restrict__ out,
                           const float* __restrict__ stats,
                           const float* __restrict__ grad_out,
                           T* __restrict__ grad, int J, int F, int H, int W,
                           float k) {
  const int bj = blockIdx.x;
  const int b = bj / J;
  const int j = bj - b * J;
  const size_t P = static_cast<size_t>(F) * F;
  const size_t ht_off = (static_cast<size_t>(b) * 4 * J + 3 * J + j) * P;
  const size_t vx_off = (static_cast<size_t>(b) * 4 * J + 3 * j) * P;
  const float* depth = img + static_cast<size_t>(b) * H * W;
  const Tables tb = build_tables(F, F, 0, H, W, 0);

  const float m = stats[2 * static_cast<size_t>(bj)];
  const float s = stats[2 * static_cast<size_t>(bj) + 1];
  const float* gj = grad_out + static_cast<size_t>(bj) * 3;
  const float* oj = out + static_cast<size_t>(bj) * 3;
  const float gx = gj[0], gy = gj[1], gd = gj[2];
  const float g_out = gx * oj[0] + gy * oj[1] + gd * oj[2];

  Cursor<V> cur(F);
  while (cur.y < F) {
    Group<V> g[kUnroll];
    bool live[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      live[u] = cur.y < F;
      at[u] = cur.y * F + cur.x;
      if (live[u])
        load_group(g[u], offset + ht_off, offset + vx_off, P, depth, tb, F,
                   cur.y, cur.x);
      cur.step(F);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      float dvx[V], dvy[V], dvd[V], dht[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float mask = g[u].d[i] < kFgThreshold ? 1.0f : 0.0f;
        const float ht = g[u].h[i] * mask;
        const float w = expf(ht * kSoftmaxTemp - m) / s;
        const float dis = k - ht * k;
        const float vx = g[u].vx[i] * mask;
        const float vy = g[u].vy[i] * mask;
        const float vd = g[u].vd[i] * mask;
        const float g_v = gx * vx + gy * vy + gd * vd;
        const float g_term = gx * (vx * dis + g[u].cx[i]) +
                             gy * (vy * dis + g[u].cy) +
                             gd * (vd * dis + g[u].d[i]);
        const float wd = w * dis * mask;
        dvx[i] = gx * wd;
        dvy[i] = gy * wd;
        dvd[i] = gd * wd;
        dht[i] = mask * w * (-k * g_v + kSoftmaxTemp * (g_term - g_out));
      }
      store_vec(grad + vx_off + at[u], dvx);
      store_vec(grad + vx_off + P + at[u], dvy);
      store_vec(grad + vx_off + 2 * P + at[u], dvd);
      store_vec(grad + ht_off + at[u], dht);
    }
  }
}

size_t table_bytes(int F, int rows) {
  return (2 * static_cast<size_t>(F) + rows) * 4;
}

template <typename T, int V>
int launch(const void* offset, const float* img, float* out, float* stats,
           int B, int J, int F, int rows, int row0, int H, int W,
           int img_row0, int img_h, float k, cudaStream_t stream) {
  decode_kernel<T, V><<<B * J, kThreads, table_bytes(F, rows), stream>>>(
      static_cast<const T*>(offset), img, out, stats, J, F, rows, row0, H, W,
      img_row0, img_h, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_backward(const void* offset, const float* img, const float* out,
                    const float* stats, const float* grad_out, void* grad,
                    int B, int J, int F, int H, int W, float k,
                    cudaStream_t stream) {
  decode_backward_kernel<T, V><<<B * J, kThreads, table_bytes(F, F),
                                 stream>>>(
      static_cast<const T*>(offset), img, out, stats, grad_out,
      static_cast<T*>(grad), J, F, H, W, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launchers: enqueue on `stream`, never synchronize, return the launch's
// CUDA error (0 when it was accepted). F % 4 == 0 takes 4-pixel groups,
// which need map pointers aligned to 4 elements (the wrapper passes such
// pointers); other F, single pixels. The decode takes the window rows
// [row0, row0 + rows) of the F x F map and the depth rows [img_row0,
// img_row0 + img_h) of the (B, H, W) depth (the full map: 0, F, 0, H).
extern "C" int awr_decode_f32(const void* offset, const float* img,
                              float* out, float* stats, int B, int J, int F,
                              int rows, int row0, int H, int W, int img_row0,
                              int img_h, float k, cudaStream_t stream) {
  return F % 4 == 0 ? launch<float, 4>(offset, img, out, stats, B, J, F,
                                       rows, row0, H, W, img_row0, img_h, k,
                                       stream)
                    : launch<float, 1>(offset, img, out, stats, B, J, F,
                                       rows, row0, H, W, img_row0, img_h, k,
                                       stream);
}

extern "C" int awr_decode_bf16(const void* offset, const float* img,
                               float* out, float* stats, int B, int J, int F,
                               int rows, int row0, int H, int W, int img_row0,
                               int img_h, float k, cudaStream_t stream) {
  return F % 4 == 0
             ? launch<__nv_bfloat16, 4>(offset, img, out, stats, B, J, F,
                                        rows, row0, H, W, img_row0, img_h, k,
                                        stream)
             : launch<__nv_bfloat16, 1>(offset, img, out, stats, B, J, F,
                                        rows, row0, H, W, img_row0, img_h, k,
                                        stream);
}

extern "C" int awr_decode_backward_f32(const void* offset, const float* img,
                                       const float* out, const float* stats,
                                       const float* grad_out, void* grad,
                                       int B, int J, int F, int H, int W,
                                       float k, cudaStream_t stream) {
  return F % 4 == 0
             ? launch_backward<float, 4>(offset, img, out, stats, grad_out,
                                         grad, B, J, F, H, W, k, stream)
             : launch_backward<float, 1>(offset, img, out, stats, grad_out,
                                         grad, B, J, F, H, W, k, stream);
}

extern "C" int awr_decode_backward_bf16(const void* offset, const float* img,
                                        const float* out, const float* stats,
                                        const float* grad_out, void* grad,
                                        int B, int J, int F, int H, int W,
                                        float k, cudaStream_t stream) {
  return F % 4 == 0
             ? launch_backward<__nv_bfloat16, 4>(offset, img, out, stats,
                                                 grad_out, grad, B, J, F, H,
                                                 W, k, stream)
             : launch_backward<__nv_bfloat16, 1>(offset, img, out, stats,
                                                 grad_out, grad, B, J, F, H,
                                                 W, k, stream);
}
