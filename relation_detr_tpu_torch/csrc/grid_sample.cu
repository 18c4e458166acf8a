// Bilinear point sampling of an NHWC map, forward and backward: the DCN's
// sampler (models/deform_conv.py, conv2 of the DCN ResNet's blocks).
//
// Replaces: relation_detr_tpu/ops/grid_sample.py::bilinear_sample (XLA, not
// Pallas: XLA fuses its four corner reads into one gather) and its autodiff
// backward. Semantics are the JAX function's: pixel coordinates, no
// half-pixel shift; x0 = floor(x) converted to int32 as XLA converts (NaN to
// 0, saturating), fx = x - x0; the corners (dy, dx) = (0, 0), (0, 1),
// (1, 0), (1, 1), at int32 sums that wrap, each read at its index clamped
// into the map and weighted by its bilinear weight where it is valid and 0
// where it is not (the JAX function's weight times validity, which XLA
// compiles to a select), summed from 0 in that order with fmaf, in fp32 (no
// TF32, no fast math). So a corner outside the map adds zero on its own, and
// a NaN point with a corner on the map gives a NaN output, a NaN point
// gradient and NaNs added to the map gradient at its valid corners, as the
// plain version (ops/grid_sample.py) and JAX give them. Offsets into the map
// are int64 (B * H * W * C may pass 2^31).
//
// What bounds it on this card. At the R50-DCN's largest sampler (layer2.0:
// a 200 x 336 x 128 map, 151,200 samples) the bytes that must move are the
// map (34.4 MB), the points and the output (77.4 MB): 0.034 ms at HBM rate;
// the backward reads the output gradient, map and points and writes the
// two gradients, 0.044 ms. The arithmetic (4 corner FMAs a channel) is far
// below the card's fp32 rate, so both are bound by bytes. Each sample reads
// 4 corner rows of C channels, 4x its output (310 MB at layer2.0), and the
// backward adds as many into the map gradient by atomics; the 9 taps of an
// output position and those of its neighbours share most of those rows.
// The first forward (a lane group a sample, 8 samples a block) read each
// block's rows from L2 with little reuse.
//
// Design:
// - Forward: G lanes a sample (G the power of two >= C / kV, at most 32;
//   kV = 4 channels a lane with 16-byte loads and stores where C % 4 == 0
//   and the tensors are 16-byte aligned, else 1), and a block owns a run of
//   `iters` passes of kThreads / G consecutive samples (the DCN's taps of
//   consecutive output positions, in raster order), so that the corner rows
//   a run's samples share are read by one SM within a few passes and its
//   L1 serves the repeats. iters is as many passes, up to kMaxIters, as
//   leave the card at least one wave of resident blocks: 4 at the
//   R50-DCN's C = 128 and 256 maps, 1 at C = 512 (1,182 single-pass
//   blocks, the first grid). The arithmetic and its order are the first
//   kernel's, so the output equals its output bit for bit.
// - Shared memory: none. A block that stages the box of its corners in
//   shared memory (16 or 32 channels a slice, by cp.async, double- or
//   single-buffered, with overflow rows for corners past the box and the
//   rest read from device memory by the same load) ran slower than this
//   kernel at every R50-DCN shape, and slower than the first kernel at the
//   C = 256 and 512 ones: the box holds rows no sample reads, each slice
//   waits on its copies, the run's planning costs a pass over its points,
//   and L1 already serves the repeated rows. So there is no window and no
//   out-of-window path: every corner is read through L1.
// - Backward: the first kernel (the G lanes of a sample add g * w into each
//   corner's row with one float4 atomicAdd a lane where a product is
//   non-zero or NaN, and reduce the point gradient's corner dots by xor
//   shuffles). Its float4 atomics, not its reads, bound it: the same kernel
//   without the corner reads takes nearly all of its time. Merging the
//   atomics of corners that neighbouring samples share first (a
//   shared-memory window of the block's box, whose fp32 shared atomics
//   compile to compare-and-swap loops on sm_90; a counting sort of the
//   box's entries by pixel, summed in registers and flushed with one float4
//   atomic a pixel and slice; per-pixel buckets gathered by a second
//   kernel; a merge across a block's samples in shared memory) ran slower
//   at every shape, the sorted window 1.5-2.4x: each needs the block's
//   samples to synchronise,
//   which exposes the L2 latency that the atomics hide. The run loop does
//   not help it either. The C entry zeroes the map gradient itself
//   (cudaMemsetAsync on the caller's stream, in place of the caller's fill
//   kernel).
// - Bit-reproducible: the forward output and the point gradient; NOT the
//   map gradient (float atomics add in an order that changes from run to
//   run).
// - Offsets are int64 (a map of B * H * W * C elements may pass 2^31).
#include <algorithm>
#include <map>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIters = 4;  // passes a block at most
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
// sample, a block `iters` passes of kThreads / G consecutive samples.
template <int kV>
__global__ void __launch_bounds__(kThreads)
bilinear_fwd_kernel(const float* __restrict__ feat, const float* __restrict__ points,
                    float* __restrict__ out, int64_t samples, int64_t N, int H, int W, int C,
                    int G, int iters) {
  const int per_pass = kThreads / G, lane = threadIdx.x % G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_pass * iters;
  const int64_t last = min(first + static_cast<int64_t>(per_pass) * iters, samples);
  for (int64_t s = first + threadIdx.x / G; s < last; s += per_pass) {
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
}

// grad_out (B, N, C) -> grad_feat (B, H, W, C) added into (zeroed by the C
// entry) and grad_points (B, N, 2) written; G lanes a sample, kThreads / G
// samples a block.
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

// The blocks of the forward kernel<kV> that the device holds at once (SMs x
// blocks an SM), worked out once per device: a launch after the first
// makes no attribute or occupancy query.
template <int kV>
int resident_blocks(int64_t* blocks) {
  static std::mutex mu;
  static std::map<int, int64_t> known;
  int device = 0;
  int code = static_cast<int>(cudaGetDevice(&device));
  if (code != 0) return code;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(device);
  if (it != known.end()) {
    *blocks = it->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  code = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (code == 0)
    code = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bilinear_fwd_kernel<kV>, kThreads, 0));
  if (code != 0) return code;
  if (per_sm < 1) return RDETR_INVALID;
  *blocks = known[device] = static_cast<int64_t>(sms) * per_sm;
  return 0;
}

// The forward's launch: as many passes a block, up to kMaxIters, as leave
// at least one wave of resident blocks.
template <int kV>
int launch_fwd(const float* feat, const float* points, float* out, int64_t samples, int64_t N,
               int H, int W, int C, cudaStream_t st) {
  int64_t resident = 0;
  const int code = resident_blocks<kV>(&resident);
  if (code != 0) return code;
  const int G = lanes_per_sample(C, kV);
  const int64_t passes = (samples + kThreads / G - 1) / (kThreads / G);
  const int iters =
      static_cast<int>(std::min<int64_t>(kMaxIters, std::max<int64_t>(1, passes / resident)));
  const int64_t blocks = (passes + iters - 1) / iters;
  if (blocks > 2147483647) return RDETR_INVALID;
  bilinear_fwd_kernel<kV><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      feat, points, out, samples, N, H, W, C, G, iters);
  RDETR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// feat (B, H, W, C), points (B, N, 2), out (B, N, C): fp32, contiguous.
extern "C" int bilinear_sample_fwd(const float* feat, const float* points, float* out,
                                   int64_t B, int64_t H, int64_t W, int64_t C, int64_t N,
                                   void* stream) {
  if (!valid_sizes(B, H, W, C, N)) return RDETR_INVALID;
  const int64_t samples = B * N;
  if (samples == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), w = static_cast<int>(W), c = static_cast<int>(C);
  if (C % 4 == 0 && aligned16(feat) && aligned16(out))
    return launch_fwd<4>(feat, points, out, samples, N, h, w, c, st);
  return launch_fwd<1>(feat, points, out, samples, N, h, w, c, st);
}

// grad_out (B, N, C) -> grad_feat (B, H, W, C), zeroed here, and
// grad_points (B, N, 2), written whole: fp32, contiguous.
extern "C" int bilinear_sample_bwd(const float* feat, const float* points,
                                   const float* grad_out, float* grad_feat, float* grad_points,
                                   int64_t B, int64_t H, int64_t W, int64_t C, int64_t N,
                                   void* stream) {
  if (!valid_sizes(B, H, W, C, N)) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const int code = static_cast<int>(cudaMemsetAsync(
        grad_feat, 0, static_cast<size_t>(B * H * W * C) * sizeof(float), s));
    if (code != 0) return code;
  }
  const int64_t samples = B * N;
  if (samples == 0) return 0;
  const int kV = C % 4 == 0 && aligned16(feat) && aligned16(grad_out) && aligned16(grad_feat)
                     ? 4 : 1;
  const int G = lanes_per_sample(C, kV);
  const int64_t blocks = (samples * G + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return RDETR_INVALID;
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
