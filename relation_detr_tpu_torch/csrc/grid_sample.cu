// Bilinear point sampling of an NHWC map, forward and backward: the DCN's
// sampler (models/deform_conv.py, conv2 of the DCN ResNet's blocks).
//
// Replaces: relation_detr_tpu/ops/grid_sample.py::bilinear_sample (XLA, not
// Pallas: XLA fuses its four corner reads into one gather) and its autodiff
// backward. Semantics are the JAX function's: pixel coordinates, no
// half-pixel shift; x0 = floor(x) converted to int32 as XLA converts (NaN to
// 0, saturating), fx = x - x0; the corners (dy, dx) = (0, 0), (0, 1),
// (1, 0), (1, 1), each read at its index clamped into the map and weighted
// by its bilinear weight where it is valid and 0 where it is not (the JAX
// function's weight times validity, which XLA compiles to a select),
// summed from 0 in that order, in fp32 (no TF32, no fast math). So a corner
// outside the map adds zero on its own, and a NaN point with a corner on
// the map gives a NaN output, a NaN point gradient and NaNs added to the
// map gradient at its valid corners, as the plain version
// (ops/grid_sample.py) and JAX give them.
//
// What bounds it on this card. At the R50-DCN's largest sampler (layer2.0:
// a 200 x 336 x 128 map, 151,200 samples) the bytes that must move are the
// map (34.4 MB), the points and the output (77.4 MB): 0.034 ms at HBM rate;
// the backward reads the output gradient, map and points and writes the
// two gradients, 0.044 ms. The arithmetic (4 corner FMAs a channel) is far
// below the card's fp32 rate, so both are bound by bytes, and in practice
// by the corner gathers: each sample reads 4 rows of C channels, 4x the
// output, most of it from L2 (neighbouring taps share corners, and every
// map fits in the 50 MB L2). The backward's map gradient is a scatter of
// the same rows, bound by L2 atomic throughput.
//
// Design (a first kernel, right and simple):
// - Lanes: G lanes per sample (G the power of two >= C / kV, at most 32),
//   kV = 4 channels a lane (16-byte loads, stores and sm_90's float4
//   atomicAdd) where C % 4 == 0 and every channel pointer is 16-byte
//   aligned, else 1. At C = 128, 256 and 512 a sample takes one warp, each
//   lane 1, 2 or 4 float4s. Consecutive samples (a DCN's taps, then its
//   output positions in raster order) are in consecutive lane groups.
// - Every lane of a sample computes the corners and weights itself (a few
//   dozen instructions, against 4 x C / G channel loads).
// - Backward: the map gradient with one vector atomic per corner and lane
//   into a zeroed fp32 map, skipped where all its products are exactly 0
//   (adding +-0 to a sum that started at +0 changes nothing); the point
//   gradient through the weights only: per corner the lane's sum of
//   g * v, reduced over the sample's G lanes by xor shuffles, 0 for a
//   corner off the map, times its weight's derivative in x and in y. The map
//   gradient is not bit-reproducible: float atomics add in an order that
//   changes from run to run.
// - Offsets are int64 (a map of B * H * W * C elements may pass 2^31).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Corners {
  int64_t row[4];  // clamped y * W + x of each corner, in its image
  float w[4];      // bilinear weight where valid, else 0
  bool valid[4];
  float fx, fy;
};

// floor(v) as XLA converts it to int32: NaN to 0, out of range saturated
// (the conversion instruction saturates).
__device__ __forceinline__ int floor_int32(float v) { return v != v ? 0 : __float2int_rd(v); }

__device__ __forceinline__ void corners(float x, float y, int H, int W, Corners& c) {
  const int x0 = floor_int32(x), y0 = floor_int32(y);
  c.fx = x - static_cast<float>(x0);
  c.fy = y - static_cast<float>(y0);
  const float wx[2] = {1.f - c.fx, c.fx};
  const float wy[2] = {1.f - c.fy, c.fy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    // int32 additions that wrap, as XLA's
    const int xc = static_cast<int>(static_cast<unsigned>(x0) + static_cast<unsigned>(dx));
    const int yc = static_cast<int>(static_cast<unsigned>(y0) + static_cast<unsigned>(dy));
    const bool ok = xc >= 0 && xc < W && yc >= 0 && yc < H;
    c.valid[k] = ok;
    c.w[k] = ok ? wx[dx] * wy[dy] : 0.f;
    c.row[k] = static_cast<int64_t>(min(max(yc, 0), H - 1)) * W + min(max(xc, 0), W - 1);
  }
}

template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int kV>
__device__ __forceinline__ void red_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// feat (B, H, W, C), points (B, N, 2) as (x, y), out (B, N, C); G lanes a
// sample, kThreads / G samples a block.
template <int kV>
__global__ void __launch_bounds__(kThreads)
bilinear_fwd_kernel(const float* __restrict__ feat, const float* __restrict__ points,
                    float* __restrict__ out, int64_t samples, int64_t N, int H, int W, int C,
                    int G) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  if (s >= samples) return;
  Corners c;
  corners(__ldg(points + 2 * s), __ldg(points + 2 * s + 1), H, W, c);
  const float* img = feat + (s / N) * H * W * static_cast<int64_t>(C);
  for (int ch = lane * kV; ch < C; ch += G * kV) {
    float acc[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[kV];
      load_vec<kV>(img + c.row[k] * C + ch, v);
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[j] = fmaf(v[j], c.w[k], acc[j]);
    }
    store_vec<kV>(out + s * C + ch, acc);
  }
}

// grad_out (B, N, C) -> grad_feat (B, H, W, C) added into (zeroed by the
// caller) and grad_points (B, N, 2) written.
template <int kV>
__global__ void __launch_bounds__(kThreads)
bilinear_bwd_kernel(const float* __restrict__ feat, const float* __restrict__ points,
                    const float* __restrict__ grad_out, float* __restrict__ grad_feat,
                    float* __restrict__ grad_points, int64_t samples, int64_t N, int H, int W,
                    int C, int G) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  const bool active = s < samples;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  Corners c;
  if (active) {  // inactive lanes still take part in the shuffles below
    corners(__ldg(points + 2 * s), __ldg(points + 2 * s + 1), H, W, c);
    const int64_t image = (s / N) * H * W * static_cast<int64_t>(C);
    for (int ch = lane * kV; ch < C; ch += G * kV) {
      float g[kV];
      load_vec<kV>(grad_out + s * C + ch, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[kV], p[kV];
        load_vec<kV>(feat + image + c.row[k] * C + ch, v);
        bool any = false;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          dot[k] = fmaf(g[j], v[j], dot[k]);
          p[j] = g[j] * c.w[k];
          any |= p[j] != 0.f;  // NaN too
        }
        if (any) red_vec<kV>(grad_feat + image + c.row[k] * C + ch, p);
      }
    }
  }
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dot[k] += __shfl_xor_sync(kFull, dot[k], off);
  }
  if (active && lane == 0) {
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = c.valid[k] ? dot[k] : 0.f;
    const float ux = 1.f - c.fx, uy = 1.f - c.fy;
    // d w / d x of (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy; then d / d y
    grad_points[2 * s] = -uy * a[0] + uy * a[1] - c.fy * a[2] + c.fy * a[3];
    grad_points[2 * s + 1] = -ux * a[0] - c.fx * a[1] + ux * a[2] + c.fx * a[3];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int lanes_per_sample(int64_t C, int kV) {
  int g = 1;
  while (g < C / kV && g < 32) g *= 2;
  return g;
}

bool valid_sizes(int64_t B, int64_t H, int64_t W, int64_t C, int64_t N) {
  return B >= 0 && N >= 0 && H >= 1 && W >= 1 && C >= 1 && H <= 2147483647 &&
         W <= 2147483647 && C <= 2147483647 && H * W <= (int64_t{1} << 62) / C;
}

}  // namespace

// feat (B, H, W, C), points (B, N, 2), out (B, N, C): fp32, contiguous.
extern "C" int bilinear_sample_fwd(const float* feat, const float* points, float* out,
                                   int64_t B, int64_t H, int64_t W, int64_t C, int64_t N,
                                   void* stream) {
  if (!valid_sizes(B, H, W, C, N)) return RDETR_INVALID;
  const int64_t samples = B * N;
  if (samples == 0) return 0;
  const int kV = C % 4 == 0 && aligned16(feat) && aligned16(out) ? 4 : 1;
  const int G = lanes_per_sample(C, kV);
  const int64_t blocks = (samples * G + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kV == 4)
    bilinear_fwd_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, points, out, samples, N, static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(C), G);
  else
    bilinear_fwd_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, points, out, samples, N, static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(C), G);
  RDETR_RETURN_LAUNCH_STATUS();
}

// grad_out (B, N, C) -> grad_feat (B, H, W, C), which the caller zeroes,
// and grad_points (B, N, 2), written whole: fp32, contiguous.
extern "C" int bilinear_sample_bwd(const float* feat, const float* points,
                                   const float* grad_out, float* grad_feat, float* grad_points,
                                   int64_t B, int64_t H, int64_t W, int64_t C, int64_t N,
                                   void* stream) {
  if (!valid_sizes(B, H, W, C, N)) return RDETR_INVALID;
  const int64_t samples = B * N;
  if (samples == 0) return 0;
  const int kV = C % 4 == 0 && aligned16(feat) && aligned16(grad_out) && aligned16(grad_feat)
                     ? 4 : 1;
  const int G = lanes_per_sample(C, kV);
  const int64_t blocks = (samples * G + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kV == 4)
    bilinear_bwd_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, points, grad_out, grad_feat, grad_points, samples, N, static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(C), G);
  else
    bilinear_bwd_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, points, grad_out, grad_feat, grad_points, samples, N, static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(C), G);
  RDETR_RETURN_LAUNCH_STATUS();
}
