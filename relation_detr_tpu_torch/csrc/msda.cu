// Multi-scale deformable attention (MSDA), forward.
//
// Replaces: relation_detr_tpu/ops/msda.py::multi_scale_deformable_attention
// (XLA, not Pallas: the tiled one-hot matmul encoder path and the corner_pack
// decoder path, both workarounds for a chip without a fast gather). Semantics
// are the gather spec at ops/msda.py:440-488: bilinear sampling with
// grid_sample(align_corners=False, padding_mode="zeros"), each of the four
// corners masked on its own, times the attention weight, summed over levels
// and points, in fp32.
//
// Design (the reference CUDA op's, SURVEY.md section 2.1): one thread per
// (b, q, head, channel). value is (B, S, H, D) with D contiguous, so the 32
// threads of a warp (D = 32) read one corner's head row as one coalesced
// 128-byte line, and write one coalesced output row. Location and weight
// loads are the same address across the warp (a broadcast).
//
// What bounds it on the card: at the encoder shape (Q = S = 22,323, H = 8,
// D = 32, L = P = 4) the value tensor is 22.9 MB and stays in the 50 MB L2,
// so the kernel is bound by L2 gather bandwidth: 64 corner rows per
// (q, head) against 128 output bytes. Later work: a warp per (q, head)
// sampling several points at once, bf16 values.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int64_t start[kMaxLevels];
};

__global__ void msda_fwd_kernel(const float* __restrict__ value, Levels lv,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                float* __restrict__ out, int64_t total,
                                int64_t S, int64_t Q, int H, int D, int L,
                                int P) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % D);
  int64_t t = idx / D;
  const int h = static_cast<int>(t % H);
  t /= H;  // = b * Q + q
  const int64_t b = t / Q;
  const int64_t qh = t * H + h;
  const float* loc_q = loc + qh * L * P * 2;    // (B, Q, H, L, P, 2)
  const float* attn_q = attn + qh * L * P;      // (B, Q, H, L, P)
  const int64_t row = static_cast<int64_t>(H) * D;  // stride of one token
  const float* value_bh = value + b * S * row + static_cast<int64_t>(h) * D + d;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float* vl = value_bh + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      const float x = loc_q[2 * lp] * wl - 0.5f;
      const float y = loc_q[2 * lp + 1] * hl - 0.5f;
      const float a = attn_q[lp];
      if (isnan(x) || isnan(y)) {  // the plain version's NaN weights
        acc = NAN;
        continue;
      }
      // every corner of a sample outside (-1, w) x (-1, h) is padding or
      // carries a zero bilinear weight
      if (!(x > -1.f && y > -1.f && x < wl && y < hl)) continue;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float fx = x - x0f;
      const float fy = y - y0f;
      const int x0 = static_cast<int>(x0f);
      const int y0 = static_cast<int>(y0f);
      // corners in the plain version's order: (0,0), (0,1), (1,0), (1,1)
      float s = 0.f;
      if (y0 >= 0) {
        if (x0 >= 0) s += vl[(static_cast<int64_t>(y0) * wl + x0) * row] * ((1.f - fx) * (1.f - fy));
        if (x0 + 1 < wl) s += vl[(static_cast<int64_t>(y0) * wl + x0 + 1) * row] * (fx * (1.f - fy));
      }
      if (y0 + 1 < hl) {
        if (x0 >= 0) s += vl[(static_cast<int64_t>(y0 + 1) * wl + x0) * row] * ((1.f - fx) * fy);
        if (x0 + 1 < wl) s += vl[(static_cast<int64_t>(y0 + 1) * wl + x0 + 1) * row] * (fx * fy);
      }
      acc += s * a;
    }
  }
  out[idx] = acc;  // (B, Q, H*D): idx is already ((b*Q + q)*H + h)*D + d
}

}  // namespace

// level_hw: host array of 2*L int64 (h0, w0, h1, w1, ...). All device
// tensors fp32 and contiguous; stream is a cudaStream_t.
extern "C" int msda_fwd(const float* value, const int64_t* level_hw,
                        const float* loc, const float* attn, float* out,
                        int64_t B, int64_t S, int64_t Q, int64_t H, int64_t D,
                        int64_t L, int64_t P, void* stream) {
  if (L < 1 || L > kMaxLevels || H < 1 || D < 1 || P < 1) return RDETR_INVALID;
  Levels lv;
  int64_t start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = static_cast<int>(level_hw[2 * l]);
    lv.w[l] = static_cast<int>(level_hw[2 * l + 1]);
    lv.start[l] = start;
    start += level_hw[2 * l] * level_hw[2 * l + 1];
  }
  if (start != S) return RDETR_INVALID;
  const int64_t total = B * Q * H * D;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  msda_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      value, lv, loc, attn, out, total, S, Q, static_cast<int>(H),
      static_cast<int>(D), static_cast<int>(L), static_cast<int>(P));
  RDETR_RETURN_LAUNCH_STATUS();
}

extern "C" const char* rdetr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
