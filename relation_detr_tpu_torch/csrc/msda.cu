// Multi-scale deformable attention (MSDA), forward and backward.
//
// Replaces: relation_detr_tpu/ops/msda.py::multi_scale_deformable_attention
// (XLA, not Pallas: the tiled one-hot matmul encoder path and the corner_pack
// decoder path, both workarounds for a chip without a fast gather) and its
// autodiff backward. On the TPU the encoder backward's value gradient is a
// windowed patch accumulation (ops/patch_scatter.py::window_accumulate);
// here the value gradient is scattered straight from each sample.
// Semantics are the gather spec at ops/msda.py:440-488: bilinear sampling
// with grid_sample(align_corners=False, padding_mode="zeros"), each of the
// four corners masked on its own, times the attention weight, summed over
// levels and points, in fp32.
//
// Design (the reference CUDA op's, SURVEY.md section 2.1): one thread per
// (b, q, head, channel). value is (B, S, H, D) with D contiguous, so the 32
// threads of a warp (D = 32) read one corner's head row as one coalesced
// 128-byte line, and write one coalesced output row. Location and weight
// loads are the same address across the warp (a broadcast).
//
// Backward (msda_bwd): the same thread layout. grad_value is a col2im
// scatter, one fp32 atomicAdd per valid corner and channel (the order of the
// adds varies from run to run). grad_attn and grad_loc are sums over the D
// channels of one (b, q, head): D divides 32 and the D threads of a head sit
// in D consecutive, aligned lanes of one warp, so an xor-shuffle reduction
// over those lanes gives the sum; the head's first lane writes it. Other D
// are refused.
//
// What bounds it on the card: at the encoder shape (Q = S = 22,323, H = 8,
// D = 32, L = P = 4) the value tensor is 22.9 MB and stays in the 50 MB L2,
// so the forward is bound by L2 gather bandwidth: 64 corner rows per
// (q, head) against 128 output bytes. The backward adds 64 atomic row
// updates per (q, head) into the 22.9 MB grad_value, also L2-resident, and
// is bound by L2 atomic throughput. Later work: a warp per (q, head)
// sampling several points at once, bf16 values, pre-reduced atomics for
// points that share a corner.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int64_t start[kMaxLevels];
};

// loc * size - 0.5 rounded after each operation, as the plain version
// computes it: a fused multiply-add would round once, and a sample that
// sits exactly on a pixel centre (every encoder sample at initialisation:
// the offset bias is whole pixels) could then floor into the neighbouring
// cell, which changes the location gradient (bilinear weights have a kink
// there).
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, static_cast<float>(size)), 0.5f);
}

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
      const float x = pixel_coord(loc_q[2 * lp], wl);
      const float y = pixel_coord(loc_q[2 * lp + 1], hl);
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

__device__ __forceinline__ float head_sum(float v, int D) {
  // sum over the D aligned lanes of one head (D a power of two <= 32)
  for (int off = D >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The grid is whole blocks of 256 threads, so every warp is whole for the
// shuffles; threads past `total` read a valid row with a zero gradient and
// write nothing.
__global__ void msda_bwd_kernel(const float* __restrict__ value, Levels lv,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const float* __restrict__ grad_out,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_loc,
                                float* __restrict__ grad_attn, int64_t total,
                                int64_t S, int64_t Q, int H, int D, int L,
                                int P) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = idx < total;
  const int64_t i = active ? idx : total - 1;
  const int d = static_cast<int>(i % D);
  int64_t t = i / D;
  const int h = static_cast<int>(t % H);
  t /= H;  // = b * Q + q
  const int64_t b = t / Q;
  const int64_t qh = t * H + h;
  const float* loc_q = loc + qh * L * P * 2;
  const float* attn_q = attn + qh * L * P;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t off_bh = b * S * row + static_cast<int64_t>(h) * D + d;
  const float* value_bh = value + off_bh;
  float* gvalue_bh = grad_value + off_bh;
  const float g = active ? grad_out[i] : 0.f;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float* vl = value_bh + lv.start[l] * row;
    float* gvl = gvalue_bh + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      const float x = pixel_coord(loc_q[2 * lp], wl);
      const float y = pixel_coord(loc_q[2 * lp + 1], hl);
      const float a = attn_q[lp];
      float g_attn = 0.f, g_x = 0.f, g_y = 0.f;
      if (isnan(x) || isnan(y)) {  // the plain version's NaN weights
        g_attn = g_x = g_y = NAN;
        if (active) atomicAdd(gvl, NAN);
      } else if (x >= -1.f && y >= -1.f && x < wl && y < hl) {
        // (outside this box every corner is padding: all gradients 0)
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
        const int64_t r00 = (static_cast<int64_t>(y0) * wl + x0) * row;
        const int64_t r01 = r00 + row;
        const int64_t r10 = r00 + static_cast<int64_t>(wl) * row;
        const int64_t r11 = r10 + row;
        const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
        const float w10 = (1.f - fx) * fy, w11 = fx * fy;
        const float v00 = (in_y0 && in_x0) ? vl[r00] : 0.f;
        const float v01 = (in_y0 && in_x1) ? vl[r01] : 0.f;
        const float v10 = (in_y1 && in_x0) ? vl[r10] : 0.f;
        const float v11 = (in_y1 && in_x1) ? vl[r11] : 0.f;
        const float s = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
        const float ga = g * a;
        g_attn = g * s;
        g_x = ga * ((v01 - v00) * (1.f - fy) + (v11 - v10) * fy) * wl;
        g_y = ga * ((v10 - v00) * (1.f - fx) + (v11 - v01) * fx) * hl;
        if (active) {
          if (in_y0 && in_x0) atomicAdd(gvl + r00, ga * w00);
          if (in_y0 && in_x1) atomicAdd(gvl + r01, ga * w01);
          if (in_y1 && in_x0) atomicAdd(gvl + r10, ga * w10);
          if (in_y1 && in_x1) atomicAdd(gvl + r11, ga * w11);
        }
      }
      g_attn = head_sum(g_attn, D);
      g_x = head_sum(g_x, D);
      g_y = head_sum(g_y, D);
      if (active && d == 0) {
        const int64_t o = qh * L * P + lp;  // (B, Q, H, L, P)
        grad_attn[o] = g_attn;
        grad_loc[2 * o] = g_x;
        grad_loc[2 * o + 1] = g_y;
      }
    }
  }
}

bool make_levels(const int64_t* level_hw, int64_t L, int64_t S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  int64_t start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = static_cast<int>(level_hw[2 * l]);
    lv->w[l] = static_cast<int>(level_hw[2 * l + 1]);
    lv->start[l] = start;
    start += level_hw[2 * l] * level_hw[2 * l + 1];
  }
  return start == S;
}

}  // namespace

// level_hw: host array of 2*L int64 (h0, w0, h1, w1, ...). All device
// tensors fp32 and contiguous; stream is a cudaStream_t.
extern "C" int msda_fwd(const float* value, const int64_t* level_hw,
                        const float* loc, const float* attn, float* out,
                        int64_t B, int64_t S, int64_t Q, int64_t H, int64_t D,
                        int64_t L, int64_t P, void* stream) {
  Levels lv;
  if (H < 1 || D < 1 || P < 1 || !make_levels(level_hw, L, S, &lv)) return RDETR_INVALID;
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

// Gradients of msda_fwd. grad_out is (B, Q, H*D); grad_value (B, S, H, D)
// must be zeroed by the caller (it is accumulated into); grad_loc
// (B, Q, H, L, P, 2) and grad_attn (B, Q, H, L, P) are written whole.
// D must be a power of two <= 32.
extern "C" int msda_bwd(const float* value, const int64_t* level_hw,
                        const float* loc, const float* attn,
                        const float* grad_out, float* grad_value,
                        float* grad_loc, float* grad_attn, int64_t B,
                        int64_t S, int64_t Q, int64_t H, int64_t D, int64_t L,
                        int64_t P, void* stream) {
  Levels lv;
  if (H < 1 || P < 1 || D < 1 || D > 32 || (D & (D - 1)) != 0 ||
      !make_levels(level_hw, L, S, &lv))
    return RDETR_INVALID;
  const int64_t total = B * Q * H * D;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  msda_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      value, lv, loc, attn, grad_out, grad_value, grad_loc, grad_attn, total,
      S, Q, static_cast<int>(H), static_cast<int>(D), static_cast<int>(L),
      static_cast<int>(P));
  RDETR_RETURN_LAUNCH_STATUS();
}

extern "C" const char* rdetr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
