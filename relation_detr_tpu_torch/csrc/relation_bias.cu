// Position-relation attention bias, v4 math, forward.
//
// Replaces: relation_detr_tpu/ops/relation_pallas.py::_kernel_v4 (entry
// fused_relation_bias_v4, via _v4_fwd), the bias the decoder adds to its
// self-attention logits. For every box pair (i, j) and head h:
//
//   out[b, h, i, j] = relu(xy[h] + wh[h] + bias[h])
//   xy[h] = sum_f sinecos_f(log(clamp(|c1_i - c2_j| / (w1_i + eps)) + 1)) * w_xy[f, h]
//   wh[h] = sum_f a_feats[b, h, i, f] * b_feats[b, f, j]
//
// The xy features are built per pair here (2 coords x E/2 frequencies x
// sin/cos = 32 features at E = 16). The wh half is separable: the folded
// per-box features (alpha|beta) and (cos|sin) come precomputed from plain
// torch, as _v4_fwd precomputes them outside its Pallas call.
//
// The ratio clamp to [0, 1e8] (relation_pallas.py:198-200) is kept: a NaN
// or Inf center gives the clamped finite bias, not NaN, in the kernel and
// in its plain version alike. sinf/cosf/logf are the accurate versions (the
// library is built without --use_fast_math): angles reach
// 100 * log(1e8 + 1) ~ 1.8e3 rad, where __sinf/__cosf lose accuracy.
//
// Design: one thread per (b, i, j); a block covers 128 consecutive j of one
// row i, so the (B, H, N1, N2) output is written coalesced along j and the
// row's alpha|beta features, the xy weights and the bias sit in shared
// memory. What bounds it on the card: the 32 accurate sin/cos per pair
// (26M at N = 900) and the 8-head x 64-feature FMAs, against 26 MB of
// output; the xy weights are read from shared memory as broadcasts.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxHalf = 32;

struct Freqs {
  float f[kMaxHalf];
};

template <int NH, int HALF>
__global__ void relation_bias_v4_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const float* __restrict__ a_feats, const float* __restrict__ b_feats,
    const float* __restrict__ w_xy, const float* __restrict__ bias, Freqs fr,
    float* __restrict__ out, int64_t N1, int64_t N2, float eps) {
  constexpr int kTwoE = 4 * HALF;  // features per half (xy or wh)
  __shared__ float a_s[NH * kTwoE];   // this row's (alpha|beta), (H, 2E)
  __shared__ float w_s[kTwoE * NH];   // xy projection, (2E, H)
  __shared__ float b_s[NH];
  const int64_t i = blockIdx.y;
  const int64_t b = blockIdx.z;
  for (int t = threadIdx.x; t < NH * kTwoE; t += blockDim.x) {
    const int h = t / kTwoE;
    const int f = t % kTwoE;
    a_s[t] = a_feats[((b * NH + h) * N1 + i) * kTwoE + f];
    w_s[t] = w_xy[t];
  }
  for (int t = threadIdx.x; t < NH; t += blockDim.x) b_s[t] = bias[t];
  __syncthreads();

  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= N2) return;

  float acc[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) acc[h] = b_s[h];

  // wh half: bilinear in the per-box features
  const float* bf = b_feats + b * kTwoE * N2 + j;
#pragma unroll 4
  for (int f = 0; f < kTwoE; ++f) {
    const float v = bf[f * N2];
#pragma unroll
    for (int h = 0; h < NH; ++h) acc[h] += a_s[h * kTwoE + f] * v;
  }

  // xy half: pair angles, sin/cos, mixed into heads
  const float* s4 = src + (b * N1 + i) * 4;
  const float* t4 = tgt + (b * N2 + j) * 4;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float ratio = fabsf(s4[c] - t4[c]) / (s4[2 + c] + eps);
    ratio = ratio < 1e8f ? ratio : 1e8f;  // NaN compares false -> 1e8
    ratio = ratio >= 0.f ? ratio : 0.f;
    const float rel = logf(ratio + 1.f);
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float ang = rel * fr.f[k];
      const float sn = sinf(ang);
      const float cs = cosf(ang);
      const int row = c * 2 * HALF + 2 * k;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        acc[h] += sn * w_s[row * NH + h] + cs * w_s[(row + 1) * NH + h];
      }
    }
  }

  float* o = out + (b * NH * N1 + i) * N2 + j;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    // relu that keeps NaN, as torch.relu does (fmaxf would drop it)
    o[h * N1 * N2] = acc[h] < 0.f ? 0.f : acc[h];
  }
}

template <int NH, int HALF>
int launch(const float* src, const float* tgt, const float* a_feats,
           const float* b_feats, const float* w_xy, const float* bias,
           const Freqs& fr, float* out, int64_t B, int64_t N1, int64_t N2,
           float eps, cudaStream_t stream) {
  constexpr int kThreads = 128;
  if (N1 > 65535 || B > 65535) return RDETR_INVALID;
  dim3 grid(static_cast<unsigned>((N2 + kThreads - 1) / kThreads),
            static_cast<unsigned>(N1), static_cast<unsigned>(B));
  relation_bias_v4_kernel<NH, HALF><<<grid, kThreads, 0, stream>>>(
      src, tgt, a_feats, b_feats, w_xy, bias, fr, out, N1, N2, eps);
  RDETR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// freqs: host array of E/2 floats. Device tensors fp32, contiguous:
// src (B, N1, 4), tgt (B, N2, 4), a_feats (B, H, N1, 2E), b_feats
// (B, 2E, N2), w_xy (2E, H), bias (H), out (B, H, N1, N2).
extern "C" int relation_bias_v4_fwd(const float* src, const float* tgt,
                                    const float* a_feats, const float* b_feats,
                                    const float* w_xy, const float* bias,
                                    const float* freqs, float* out, int64_t B,
                                    int64_t N1, int64_t N2, int64_t H,
                                    int64_t E, float eps, void* stream) {
  if (B * N1 * N2 == 0) return 0;
  if (E != 16) return RDETR_INVALID;  // the only embed width instantiated
  Freqs fr;
  for (int k = 0; k < E / 2; ++k) fr.f[k] = freqs[k];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 4:
      return launch<4, 8>(src, tgt, a_feats, b_feats, w_xy, bias, fr, out, B, N1, N2, eps, s);
    case 8:
      return launch<8, 8>(src, tgt, a_feats, b_feats, w_xy, bias, fr, out, B, N1, N2, eps, s);
    case 16:
      return launch<16, 8>(src, tgt, a_feats, b_feats, w_xy, bias, fr, out, B, N1, N2, eps, s);
    default:
      return RDETR_INVALID;
  }
}
