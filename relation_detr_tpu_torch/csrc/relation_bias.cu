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
// The xy features are built per pair (2 coords x E/2 frequencies x sin/cos
// = 32 features at E = 16). The wh half is separable: row i's features
// alpha|beta (the wh projection weights folded in) and column j's cos|sin,
// which _v4_fwd computes in XLA outside its Pallas call, are computed here,
// inside the one launch, from the boxes and the weights.
//
// The ratio clamp to [0, 1e8] (relation_pallas.py:198-200) is kept: a NaN
// or Inf center gives the clamped finite bias, not NaN, in the kernel and
// in its plain version alike. A NaN or Inf width or height gives NaN
// through the wh features, and the ReLU keeps NaN.
//
// What bounds it on the card: the operations. Per pair and head 64 FMAs
// (32 xy features, 32 wh features), and per pair 16 sine-cosine pairs of
// angles up to 100 * log(1e8 + 1) ~ 1.8e3 rad, against 26 MB of output at
// N = 900 (0.0128 ms of operations, 0.0078 ms of bytes). The previous
// design took 0.069 ms at N = 900 (NVIDIA H100 80GB HBM3, 700.00 W): one
// thread per pair calling the accurate sinf and cosf, each with its own
// argument reduction, 32 global loads of precomputed column features per
// pair and a shared-memory load per FMA; and its wrapper prepared the wh
// features with ~20 small torch ops and a host-to-device copy per call
// (0.33-0.47 ms a call). This design:
// * one launch per call, with the weights read through their strides, so
//   conv.weight's (H, 4E) layout is read in place: the block stages the
//   weights and the bias, then folds its rows' alpha|beta into shared
//   memory ((R, 2E, H): R rows x 16 sine-cosine pairs, one per thread);
// * a block tile of kCols = 128 columns j (one per thread) x R rows i
//   (kRowsH4 / kRowsH8 / kRowsH16 by head count): each thread computes its
//   column's 32 cos|sin wh features once, into registers, while the
//   block's staging loads land, and reuses them over the R rows (2 at 8
//   heads, the fastest of 2, 4 and 8 on the H100: more, smaller blocks
//   beat fewer column prologues); the rows' features and the xy weights
//   are read as
//   float4 broadcasts, each used for 4 heads (wh) or 4 heads x R rows (xy);
// * sincos_rr (common.cuh): one argument reduction per angle for both its
//   sine and its cosine, the xy angles in [0, 1.9e3] rad and the wh ones in
//   [-9e3, 9e3].
// Warps whose 32 columns all lie past N2 leave after the staging.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHalf = 8;          // E / 2 frequencies (E = 16, the only width instantiated)
constexpr int kFeat = 4 * kHalf;  // features per half (xy or wh)
constexpr int kCols = 128;        // columns j per block, one per thread
constexpr int kRowsH4 = 4;        // rows i per block at 4 heads
constexpr int kRowsH8 = 2;        // at 8 heads
constexpr int kRowsH16 = 2;       // at 16 heads

struct Freqs {
  float f[kHalf];
};

template <int NH, int R>
__global__ void __launch_bounds__(kCols) relation_bias_v4_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt, const float* __restrict__ w,
    int64_t wsf, int64_t wsh, const float* __restrict__ bias, Freqs fr,
    float* __restrict__ out, int N1, int N2, float eps) {
  constexpr int NQ = NH / 4;
  __shared__ __align__(16) float w_s[2 * kFeat * NH];  // (4E, H): xy rows, then wh rows
  __shared__ __align__(16) float ab_s[R * kFeat * NH];  // the rows' alpha|beta, (R, 2E, H)
  __shared__ float box_s[R][4];                         // cx, cy, w + eps, h + eps
  __shared__ float b_s[NH];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kCols + tid;
  const float* tb = tgt + (static_cast<int64_t>(b) * N2 + min(j, N2 - 1)) * 4;
  const float cx2 = tb[0];
  const float cy2 = tb[1];
  const float tw = tb[2];
  const float th = tb[3];
  for (int t = tid; t < 2 * kFeat * NH; t += kCols)
    w_s[t] = w[(t / NH) * wsf + (t % NH) * wsh];
  if (tid < NH) b_s[tid] = bias[tid];
  if (tid < 4 * R) {
    const int r = tid / 4;
    const int k = tid % 4;
    const float v = src[(static_cast<int64_t>(b) * N1 + min(i0 + r, N1 - 1)) * 4 + k];
    box_s[r][k] = k < 2 ? v : v + eps;
  }
  // the column's cos|sin wh features (_v4_fwd's b_feats), while the loads land
  float bq[kFeat];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float q = logf((c == 0 ? tw : th) + eps);
#pragma unroll
    for (int k = 0; k < kHalf; ++k)
      sincos_rr(q * fr.f[k], &bq[2 * (c * kHalf + k) + 1], &bq[2 * (c * kHalf + k)]);
  }
  __syncthreads();
  // the rows' wh features with the wh weights folded in (_v4_fwd's a_feats):
  // feature 2 (c E/2 + k) is alpha, 2 (c E/2 + k) + 1 beta
  for (int u = tid; u < R * 2 * kHalf; u += kCols) {
    const int r = u / (2 * kHalf);
    const int ck = u % (2 * kHalf);
    float sp, cp;
    sincos_rr(logf(box_s[r][2 + ck / kHalf]) * fr.f[ck % kHalf], &sp, &cp);
    const float* ws = w_s + (kFeat + 2 * ck) * NH;  // the sine's weights, then the cosine's
    const float* wc = ws + NH;
    float* a = ab_s + (r * kFeat + 2 * ck) * NH;
    for (int h = 0; h < NH; ++h) {
      a[h] = sp * ws[h] + cp * wc[h];
      a[NH + h] = sp * wc[h] - cp * ws[h];
    }
  }
  __syncthreads();
  if ((j & ~31) >= N2) return;  // the whole warp lies past the last column

  float acc[R][NH];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < NH; ++h) acc[r][h] = b_s[h];

  {  // wh half: the column's features against the rows'
    const float4* ab4 = reinterpret_cast<const float4*>(ab_s);
#pragma unroll
    for (int f = 0; f < kFeat; ++f)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 a = ab4[(r * kFeat + f) * NQ + q];
          acc[r][4 * q] = fmaf(a.x, bq[f], acc[r][4 * q]);
          acc[r][4 * q + 1] = fmaf(a.y, bq[f], acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(a.z, bq[f], acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(a.w, bq[f], acc[r][4 * q + 3]);
        }
  }

  // xy half: pair angles, sine and cosine, mixed into heads
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const float c2 = c == 0 ? cx2 : cy2;
    float rel[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ratio = fabsf(box_s[r][c] - c2) / box_s[r][2 + c];
      ratio = ratio < 1e8f ? ratio : 1e8f;  // NaN compares false -> 1e8
      ratio = ratio >= 0.f ? ratio : 0.f;
      rel[r] = logf(ratio + 1.f);
    }
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      float4 wsn[NQ], wcs[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        wsn[q] = w4[(c * 2 * kHalf + 2 * k) * NQ + q];
        wcs[q] = w4[(c * 2 * kHalf + 2 * k + 1) * NQ + q];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sn, cs;
        sincos_rr(rel[r] * fr.f[k], &sn, &cs);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          acc[r][4 * q] = fmaf(cs, wcs[q].x, fmaf(sn, wsn[q].x, acc[r][4 * q]));
          acc[r][4 * q + 1] = fmaf(cs, wcs[q].y, fmaf(sn, wsn[q].y, acc[r][4 * q + 1]));
          acc[r][4 * q + 2] = fmaf(cs, wcs[q].z, fmaf(sn, wsn[q].z, acc[r][4 * q + 2]));
          acc[r][4 * q + 3] = fmaf(cs, wcs[q].w, fmaf(sn, wsn[q].w, acc[r][4 * q + 3]));
        }
      }
    }
  }

  if (j >= N2) return;
  const int64_t plane = static_cast<int64_t>(N1) * N2;
  float* o = out + static_cast<int64_t>(b) * NH * plane + static_cast<int64_t>(i0) * N2 + j;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r >= N1) break;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      // relu that keeps NaN, as torch.relu does (fmaxf would drop it)
      o[h * plane + r * N2] = acc[r][h] < 0.f ? 0.f : acc[r][h];
    }
  }
}

template <int NH, int R>
int launch(const float* src, const float* tgt, const float* w, int64_t wsf, int64_t wsh,
           const float* bias, const Freqs& fr, float* out, int64_t B, int64_t N1, int64_t N2,
           float eps, cudaStream_t stream) {
  if (B > 65535 || (N1 + R - 1) / R > 65535 || N1 > (1 << 30) || N2 > (1 << 30))
    return RDETR_INVALID;
  dim3 grid(static_cast<unsigned>((N2 + kCols - 1) / kCols),
            static_cast<unsigned>((N1 + R - 1) / R), static_cast<unsigned>(B));
  relation_bias_v4_kernel<NH, R><<<grid, kCols, 0, stream>>>(
      src, tgt, w, wsf, wsh, bias, fr, out, static_cast<int>(N1), static_cast<int>(N2), eps);
  RDETR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// freqs: host array of E/2 floats. Device tensors fp32: src (B, N1, 4), tgt
// (B, N2, 4), bias (H) and out (B, H, N1, N2) contiguous; w the (4E, H)
// projection, element (f, h) at w[f * w_stride_f + h * w_stride_h] (conv's
// (H, 4E) weight read as its transpose: strides 1 and 4E).
extern "C" int relation_bias_v4_fwd(const float* src, const float* tgt, const float* w,
                                    int64_t w_stride_f, int64_t w_stride_h,
                                    const float* bias, const float* freqs, float* out,
                                    int64_t B, int64_t N1, int64_t N2, int64_t H, int64_t E,
                                    float eps, void* stream) {
  if (B * N1 * N2 == 0) return 0;
  if (E != 2 * kHalf) return RDETR_INVALID;  // the only embed width instantiated
  Freqs fr;
  for (int k = 0; k < kHalf; ++k) fr.f[k] = freqs[k];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 4:
      return launch<4, kRowsH4>(src, tgt, w, w_stride_f, w_stride_h, bias, fr, out, B, N1, N2,
                                eps, s);
    case 8:
      return launch<8, kRowsH8>(src, tgt, w, w_stride_f, w_stride_h, bias, fr, out, B, N1, N2,
                                eps, s);
    case 16:
      return launch<16, kRowsH16>(src, tgt, w, w_stride_f, w_stride_h, bias, fr, out, B, N1,
                                  N2, eps, s);
    default:
      return RDETR_INVALID;
  }
}
