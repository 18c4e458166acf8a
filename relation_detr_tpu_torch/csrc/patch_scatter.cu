// Windowed accumulate: the sum of nt (ph, pw, C) windows placed at origins
// (y0, x0) on an (h, w, C) canvas.
//
// Replaces: relation_detr_tpu/ops/patch_scatter.py::_accum_kernel (entry
// window_accumulate), the adjoint of the tiled MSDA's patch extraction
// (ops/msda.py::_slice_patches_bwd) in the JAX train step on the TPU. The
// TPU kernel keeps a canvas block in VMEM across a sequential grid over the
// windows; Hopper's blocks run in no order, so the sequential grid becomes
// a loop inside the thread.
//
// What bounds it on the card: the bytes. Every window element is read once
// (nt * ph * pw * C floats, 84.6 MB at the flagship's encoder level 0:
// nt = 189 windows of 23 x 19 x 256) and every canvas element written once
// (17.2 MB): 101.8 MB, 0.030 ms at 3.35 TB/s.
//
// Design: the wrapper (ops/patch_scatter.py) builds, once per geometry and
// device, a covering-window table in CSR form: for each canvas position
// (y, x) the ascending list of the window rows ((k * ph + dy) * pw + dx)
// that land on it, k ascending. One thread per float4 of channels (64
// threads per position at C = 256) walks its position's slice, adds the
// 16-byte window loads into a register float4 starting from 0, and writes
// the canvas once. That is the TPU kernel's order of additions exactly, so
// the sums are bit-identical to it and no atomics are needed; the walk is
// unrolled by 8 so that eight independent loads are in flight (a position
// of the flagship's level 3 sums up to 189 windows). Any in-canvas origins
// work, repeated ones too. C not a multiple of 4 (or an unaligned pointer)
// takes the same walk one float per thread.
//
// The previous design ran one thread per canvas element that tested all nt
// origins (189 x 2 loads and 4 compares per element, 3.3 G iterations at
// level 0) and the wrapper copied the origins to the card on every call:
// 0.4626 ms at level 0 for the whole wrapper, against torch.index_add's
// 0.1681 ms (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 3).
#include "common.cuh"

namespace {

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

// V = float4 or float; cv = C / (floats per V), the threads of one position.
template <typename V>
__global__ void window_accumulate_kernel(const V* __restrict__ g, const int* __restrict__ offsets,
                                         const int* __restrict__ rows, V* __restrict__ out,
                                         int64_t total, int cv) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t pos = idx / cv;
  const int c = static_cast<int>(idx - pos * cv);
  const int end = offsets[pos + 1];
  int j = offsets[pos];
  V acc = zero<V>();
  constexpr int kUnroll = 8;
  for (; j + kUnroll <= end; j += kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(&g[static_cast<int64_t>(rows[j + u]) * cv + c]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_to(acc, v[u]);
  }
  for (; j < end; ++j) add_to(acc, __ldg(&g[static_cast<int64_t>(rows[j]) * cv + c]));
  out[idx] = acc;
}

}  // namespace

// g (nt, ph, pw, C) fp32; offsets (h * w + 1,) and rows (nt * ph * pw,) int32
// on the device: the covering-window table (rows of g viewed as
// (nt * ph * pw, C), ascending per position); out (h, w, C) fp32, written
// whole.
extern "C" int window_accumulate(const float* g, const int* offsets, const int* rows, float* out,
                                 int64_t positions, int64_t C, void* stream) {
  if (positions < 0 || C < 1 || C > 2147483647) return RDETR_INVALID;
  if (positions == 0) return 0;
  constexpr int kThreads = 256;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int cv = static_cast<int>(vec ? C / 4 : C);
  const int64_t total = positions * cv;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    window_accumulate_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(g), offsets, rows, reinterpret_cast<float4*>(out),
        total, cv);
  else
    window_accumulate_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        g, offsets, rows, out, total, cv);
  RDETR_RETURN_LAUNCH_STATUS();
}
