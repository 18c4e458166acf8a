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
// rounded, as relation_pallas.py::_freqs. The relu keeps NaN (a NaN or Inf
// in rel gives NaN), as torch.relu does.
//
// What bounds it on the card: the operations. Per pair 32 sine-cosine pairs
// of angles up to ~1e3 rad and 64 x H FMAs, against 16 bytes in and 4 H
// bytes out (N = 900, H = 8: 0.0132 ms of operations, 0.0116 ms of bytes).
// The previous design took 0.086 ms at N = 900 (NVIDIA H100 80GB HBM3,
// 700.00 W): the accurate sinf and cosf, 64 calls a pair, each with its own
// argument reduction and slow-path branch (about twice the instructions of
// the projection); one 128-thread block per 128 columns j of one row i,
// each staging the weights again (7,200 blocks at N = 900, the last of each
// row 4 threads busy of 128) and reading them as scalar broadcasts. This
// design:
// * the (i, j) pairs of an image are one flat range, as both rel and each
//   head's plane of out lie in memory: a block of kRelThreads threads
//   covers kRelThreads x P consecutive pairs (thread t the pairs t,
//   t + kRelThreads, ...; P = kPairsH4 / kPairsH8 / kPairsH16 by head
//   count), so every load of rel (one float4 a pair) and every store of a
//   head's plane is coalesced and no thread idles but in the image's last
//   block;
// * the weights and bias are staged once per block, while the block's rel
//   loads land, and read as float4 broadcasts, each feeding 4 heads x P
//   pairs;
// * sincos_rr (common.cuh): one argument reduction per angle for its sine
//   and its cosine.
#include "common.cuh"

namespace {

constexpr int kHalf = 8;  // embed_dim 16: 8 frequencies per coordinate
constexpr int kFeats = 4 * 2 * kHalf;
constexpr int kRelThreads = 128;  // threads per block
constexpr int kPairsH4 = 4;       // pairs per thread at 4 heads
constexpr int kPairsH8 = 2;       // at 8 heads
constexpr int kPairsH16 = 1;      // at 16 heads

struct Freqs {
  float f[kHalf];
};

template <int NH, int P>
__global__ void __launch_bounds__(kRelThreads) relation_bias_rel_kernel(
    const float4* __restrict__ rel, const float* __restrict__ w, const float* __restrict__ bias,
    Freqs fr, float* __restrict__ out, int64_t pairs) {
  constexpr int NQ = NH / 4;
  __shared__ __align__(16) float w_s[kFeats * NH];  // (64, H)
  __shared__ float b_s[NH];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * (kRelThreads * P) + tid;
  float4 r[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int64_t p = p0 + u * kRelThreads;
    r[u] = p < pairs ? rel[b * pairs + p] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int t = tid; t < kFeats * NH; t += kRelThreads) w_s[t] = w[t];
  if (tid < NH) b_s[tid] = bias[tid];
  __syncthreads();

  float acc[P][NH];
#pragma unroll
  for (int u = 0; u < P; ++u)
#pragma unroll
    for (int h = 0; h < NH; ++h) acc[u][h] = b_s[h];
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int row = c * 2 * kHalf + 2 * k;
      float4 wsn[NQ], wcs[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        wsn[q] = w4[row * NQ + q];
        wcs[q] = w4[(row + 1) * NQ + q];
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float v = c == 0 ? r[u].x : c == 1 ? r[u].y : c == 2 ? r[u].z : r[u].w;
        float sn, cs;
        sincos_rr(v * fr.f[k], &sn, &cs);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          acc[u][4 * q] = fmaf(cs, wcs[q].x, fmaf(sn, wsn[q].x, acc[u][4 * q]));
          acc[u][4 * q + 1] = fmaf(cs, wcs[q].y, fmaf(sn, wsn[q].y, acc[u][4 * q + 1]));
          acc[u][4 * q + 2] = fmaf(cs, wcs[q].z, fmaf(sn, wsn[q].z, acc[u][4 * q + 2]));
          acc[u][4 * q + 3] = fmaf(cs, wcs[q].w, fmaf(sn, wsn[q].w, acc[u][4 * q + 3]));
        }
      }
    }
  }

  float* o = out + b * NH * pairs;
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int64_t p = p0 + u * kRelThreads;
    if (p >= pairs) break;
#pragma unroll
    for (int h = 0; h < NH; ++h)
      o[h * pairs + p] = acc[u][h] < 0.f ? 0.f : acc[u][h];  // relu keeping NaN, as torch.relu
  }
}

template <int NH, int P>
int launch(const float* rel, const float* w, const float* bias, const Freqs& fr, float* out,
           int64_t B, int64_t pairs, cudaStream_t stream) {
  const int64_t blocks = (pairs + kRelThreads * P - 1) / (kRelThreads * P);
  if (B > 65535 || blocks > 2147483647) return RDETR_INVALID;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  relation_bias_rel_kernel<NH, P><<<grid, kRelThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rel), w, bias, fr, out, pairs);
  RDETR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// freqs: host array of E/2 floats. Device tensors fp32, contiguous: rel
// (B, N1, N2, 4), 16-byte aligned; w (4E, H), bias (H), out (B, H, N1, N2),
// written whole.
extern "C" int relation_bias_rel_fwd(const float* rel, const float* w, const float* bias,
                                     const float* freqs, float* out, int64_t B, int64_t N1,
                                     int64_t N2, int64_t H, int64_t E, void* stream) {
  if (B * N1 * N2 == 0) return 0;
  if (E != 2 * kHalf) return RDETR_INVALID;  // the only embed width instantiated
  if (reinterpret_cast<uintptr_t>(rel) % 16 != 0) return RDETR_INVALID;
  Freqs fr;
  for (int k = 0; k < kHalf; ++k) fr.f[k] = freqs[k];
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t pairs = N1 * N2;
  switch (H) {
    case 4:
      return launch<4, kPairsH4>(rel, w, bias, fr, out, B, pairs, s);
    case 8:
      return launch<8, kPairsH8>(rel, w, bias, fr, out, B, pairs, s);
    case 16:
      return launch<16, kPairsH16>(rel, w, bias, fr, out, B, pairs, s);
    default:
      return RDETR_INVALID;
  }
}
