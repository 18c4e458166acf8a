// Position-relation attention bias from a precomputed relation tensor.
//
// Replaces: relation_detr_tpu/ops/relation_pallas.py::_kernel (v1) and
// ::_kernel_v2 (entry fused_relation_bias, via _fused_fwd), the opt-in
// relation versions 1 and 2. Both TPU kernels compute one function and
// differ only in how they feed the TPU (v1: per-head accumulators on the
// VPU over row blocks; v2: a (64, L) feature block and one MXU dot):
//
//   out[b, h, i, j] = relu(bias[h] + sum_f feat_f(rel[b, i, j]) * W[f, h])
//
// rel (B, N1, N2, 4) is box_rel_encoding's output; the 64 features are, in
// _kernel's order, coordinate c, frequency k, then sin and cos of
// rel[c] * freqs[k] (row c * 16 + 2k and 2k + 1 of W), the order of
// get_sine_pos_embed(exchange_xy=False). freqs are computed in float64 and
// rounded, as relation_pallas.py::_freqs. sinf/cosf are the accurate
// versions (no --use_fast_math): angles reach ~1e3 rad.
//
// Design: one thread per (b, i, j) with H accumulators in registers, as
// relation_bias.cu; a block covers 128 consecutive j of one row i, so the
// rel reads (16 bytes a thread) and the (B, H, N1, N2) writes are
// coalesced, and W and the bias sit in shared memory, read as broadcasts.
// Bound on the card: the 64 accurate sin/cos and 64 x H FMAs per pair
// (operations), against 16 bytes in and 4 H bytes out per pair.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHalf = 8;  // embed_dim 16: 8 frequencies per coordinate
constexpr int kFeats = 4 * 2 * kHalf;

struct Freqs {
  float f[kHalf];
};

template <int NH>
__global__ void relation_bias_rel_kernel(const float* __restrict__ rel,
                                         const float* __restrict__ w,
                                         const float* __restrict__ bias, Freqs fr,
                                         float* __restrict__ out, int64_t N1, int64_t N2) {
  __shared__ float w_s[kFeats * NH];  // (64, H)
  __shared__ float b_s[NH];
  for (int t = threadIdx.x; t < kFeats * NH; t += blockDim.x) w_s[t] = w[t];
  for (int t = threadIdx.x; t < NH; t += blockDim.x) b_s[t] = bias[t];
  __syncthreads();
  const int64_t i = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= N2) return;

  float acc[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) acc[h] = b_s[h];
  const float* r = rel + ((b * N1 + i) * N2 + j) * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float p = r[c];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float ang = p * fr.f[k];
      const float sn = sinf(ang);
      const float cs = cosf(ang);
      const int row = c * 2 * kHalf + 2 * k;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        acc[h] += sn * w_s[row * NH + h];
        acc[h] += cs * w_s[(row + 1) * NH + h];
      }
    }
  }
  float* o = out + (b * NH * N1 + i) * N2 + j;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    o[h * N1 * N2] = acc[h] < 0.f ? 0.f : acc[h];  // relu keeping NaN, as torch.relu
  }
}

template <int NH>
int launch(const float* rel, const float* w, const float* bias, const Freqs& fr, float* out,
           int64_t B, int64_t N1, int64_t N2, cudaStream_t stream) {
  constexpr int kThreads = 128;
  if (N1 > 65535 || B > 65535) return RDETR_INVALID;
  dim3 grid(static_cast<unsigned>((N2 + kThreads - 1) / kThreads), static_cast<unsigned>(N1),
            static_cast<unsigned>(B));
  relation_bias_rel_kernel<NH><<<grid, kThreads, 0, stream>>>(rel, w, bias, fr, out, N1, N2);
  RDETR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// freqs: host array of E/2 floats. Device tensors fp32, contiguous: rel
// (B, N1, N2, 4), w (4E, H), bias (H), out (B, H, N1, N2), written whole.
extern "C" int relation_bias_rel_fwd(const float* rel, const float* w, const float* bias,
                                     const float* freqs, float* out, int64_t B, int64_t N1,
                                     int64_t N2, int64_t H, int64_t E, void* stream) {
  if (B * N1 * N2 == 0) return 0;
  if (E != 2 * kHalf) return RDETR_INVALID;  // the only embed width instantiated
  Freqs fr;
  for (int k = 0; k < kHalf; ++k) fr.f[k] = freqs[k];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 4:
      return launch<4>(rel, w, bias, fr, out, B, N1, N2, s);
    case 8:
      return launch<8>(rel, w, bias, fr, out, B, N1, N2, s);
    case 16:
      return launch<16>(rel, w, bias, fr, out, B, N1, N2, s);
    default:
      return RDETR_INVALID;
  }
}
