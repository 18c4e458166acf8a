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
// Design: one thread per canvas element (y, x, c), c fastest, so a warp
// reads 32 consecutive channels of a window row and writes 32 consecutive
// canvas floats. Each thread walks the windows in ascending order and adds
// those that cover it, starting from 0: the TPU kernel's order of
// additions exactly, so the sums are bit-identical to it and no atomics are
// needed. What bounds it on the card: the window reads (nt * ph * pw * C
// floats, 84.6 MB at the flagship's encoder level 0: nt = 189 windows of
// 23 x 19 x 256) and one canvas write (17.2 MB); the origin tests cost
// nt integer compares per element, on origins that every warp reads as one
// broadcast.
#include "common.cuh"

namespace {

__global__ void window_accumulate_kernel(const float* __restrict__ g,
                                         const int* __restrict__ y0s,
                                         const int* __restrict__ x0s,
                                         float* __restrict__ out, int64_t total,
                                         int nt, int ph, int pw, int C, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const int64_t t = idx / C;
  const int x = static_cast<int>(t % w);
  const int y = static_cast<int>(t / w);
  float acc = 0.f;
  for (int k = 0; k < nt; ++k) {
    const int dy = y - y0s[k];
    const int dx = x - x0s[k];
    if (dy >= 0 && dy < ph && dx >= 0 && dx < pw)
      acc += g[((static_cast<int64_t>(k) * ph + dy) * pw + dx) * C + c];
  }
  out[idx] = acc;
}

}  // namespace

// g (nt, ph, pw, C) fp32, y0s/x0s (nt,) int32 on the device, out (h, w, C)
// fp32, written whole. Every window must lie inside the canvas.
extern "C" int window_accumulate(const float* g, const int* y0s, const int* x0s,
                                 float* out, int64_t nt, int64_t ph,
                                 int64_t pw, int64_t C, int64_t h, int64_t w,
                                 void* stream) {
  if (nt < 0 || ph < 1 || pw < 1 || C < 1 || h < ph || w < pw) return RDETR_INVALID;
  const int64_t total = h * w * C;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  window_accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      g, y0s, x0s, out, total, static_cast<int>(nt), static_cast<int>(ph),
      static_cast<int>(pw), static_cast<int>(C), static_cast<int>(w));
  RDETR_RETURN_LAUNCH_STATUS();
}
