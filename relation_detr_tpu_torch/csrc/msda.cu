// Multi-scale deformable attention (MSDA), forward and backward.
//
// Replaces: relation_detr_tpu/ops/msda.py::multi_scale_deformable_attention
// (XLA, not Pallas: the tiled one-hot matmul encoder path and the corner_pack
// decoder path, both workarounds for a chip without a fast gather) and its
// autodiff backward. On the TPU the encoder backward's value gradient is a
// windowed patch accumulation (ops/patch_scatter.py::window_accumulate);
// here the value gradient is scattered from each sample.
// Semantics are the gather spec at ops/msda.py:440-488: bilinear sampling
// with grid_sample(align_corners=False, padding_mode="zeros"), each of the
// four corners masked on its own, times the attention weight, summed over
// levels and points, in fp32 (no TF32, no fast math). A NaN location gives
// a NaN output, NaN location and weight gradients, and a NaN added to the
// level's first value row of that head; a location outside the level
// samples zero padding.
//
// What bounds it on this card. At the encoder shape (Q = S = 22,323, H = 8,
// D = 32, L = P = 4) the bytes that must move (value, locations, weights,
// output) are 80 MB, 0.024 ms at HBM rate, and the 22.9 MB value tensor
// stays in the 50 MB L2. The forward is bound by its gathers: each
// (q, head) reads 64 corner rows of 128 bytes, 1.46 GB per call. The
// backward adds a scatter of the same 64 rows per (q, head) into grad_value
// (also L2-resident), and is bound by L2 atomic throughput. The first design
// (one thread per (b, q, head, channel), a 256-thread block per query, 48
// broadcast loads of the locations and weights per lane, scalar corner
// loads; backward: 4 scalar fp32 atomics per sample and lane, 365 M
// read-modify-writes in L2 per encoder call, and 3 x 5 shuffles per
// sample) took 0.461 ms forward and 0.842 ms backward on an NVIDIA H100
// 80GB HBM3 at 700 W.
//
// This design:
// - Lanes: G lanes per (b, q, head) item, each holding kV = 4 channels
//   (16-byte loads, stores and atomics; 8 lanes per head at D = 32, so a
//   warp takes four items). kV drops to 2 or 1 when D or a pointer's
//   alignment does not allow 16 bytes. Blocks of kThreads threads take
//   consecutive items in memory order, a query's heads in neighbouring
//   lanes: coalesced locations, weights, output and output gradient. The
//   loads go through the read-only path. In the encoder layout neighbouring
//   queries (raster order) sample neighbouring corners; how many corner
//   reads that saves in L1 or L2 was not profiled.
// - Locations and weights: the G lanes of an item load its L * P samples'
//   (x, y) and weight in chunks of 2G samples, two per lane, across level
//   boundaries, and broadcast each sample in turn by shuffles, instead of
//   one broadcast load per sample and lane. At L = P = 4 and G = 8 that is
//   one chunk: 128 contiguous bytes of locations and 64 of weights.
// - Backward, value gradient: one float4 atomic per corner and lane
//   (sm_90's vector atomicAdd), a quarter of the scalar atomics. These
//   atomics are what bounds the backward now, we expect: it takes ~3.5x
//   the forward, which reads the same corners.
// - Backward, location and weight gradients: each lane sums its kV
//   channels first, then one reduce-scatter over the item's lanes per
//   sample (4 shuffles at G = 8 instead of 15) leaves the weight and the
//   two location gradients on three lanes, which store them.
// - Tried on the H100 and dropped, each slower or no faster at the
//   encoder shape: a block per 2D tile of one level's tokens and one head,
//   so that neighbours share an SM's L1 (the forward no faster; why was
//   not profiled); in that tiling, a per-level shared-memory window of
//   grad_value rows summed with shared-memory atomics and flushed once
//   (the backward slower: the shared atomics seem to cost more than the
//   global ones they save); a lane group walking a run of 2-8 consecutive
//   queries per point and holding the corner sums that neighbours share in
//   registers (fewer items in flight: slower, except on the
//   initialisation's identical offsets).
// - The backward is not deterministic: float atomics add in a different
//   order from run to run. grad_value must be zeroed by the caller.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// a location that samples nothing (for lanes past the last item)
constexpr float kFar = -8.f;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int64_t start[kMaxLevels];
};

struct Problem {
  const float* value;  // (B, S, H, D)
  const float* loc;    // (B, Q, H, L, P, 2)
  const float* attn;   // (B, Q, H, L, P)
  int64_t S, Q;
  int H, D, L, P;
  int G;          // lanes per item, a power of two <= 32
  int ncb;        // forward: channel blocks of G * kV channels
  int64_t items;  // B * Q * H
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

// Two samples per lane: lane j of an item's group holds samples s0 + 2j and
// s0 + 2j + 1 (of those below s_end). The item's L * P samples are read in
// chunks of 2G across level boundaries; at L * P <= 2G (the flagship) one
// chunk, loaded before the loops (reloading it inside them made the forward
// spill registers).
struct Chunk {
  float2 l0, l1;
  float a0, a1;
};

__device__ __forceinline__ Chunk load_chunk(const float* loc_i, const float* attn_i, int s0,
                                            int s_end, int j, bool valid) {
  const int s = s0 + 2 * j;
  Chunk c;
  const bool in0 = valid && s < s_end, in1 = valid && s + 1 < s_end;
  // scalar loads: a contiguous view need not be 8-byte aligned
  c.l0 = in0 ? make_float2(__ldg(loc_i + 2 * s), __ldg(loc_i + 2 * s + 1))
             : make_float2(kFar, kFar);
  c.l1 = in1 ? make_float2(__ldg(loc_i + 2 * s + 2), __ldg(loc_i + 2 * s + 3))
             : make_float2(kFar, kFar);
  c.a0 = in0 ? __ldg(attn_i + s) : 0.f;
  c.a1 = in1 ? __ldg(attn_i + s + 1) : 0.f;
  return c;
}

// Sample r of the chunk, from the lane of the group that holds it.
struct Sample {
  float x, y, a;
};

__device__ __forceinline__ Sample take(const Chunk& c, int r, int gbase) {
  const int src = gbase + (r >> 1);
  const bool odd = r & 1;
  Sample s;
  s.x = __shfl_sync(kFull, odd ? c.l1.x : c.l0.x, src);
  s.y = __shfl_sync(kFull, odd ? c.l1.y : c.l0.y, src);
  s.a = __shfl_sync(kFull, odd ? c.a1 : c.a0, src);
  return s;
}

template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (kV == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// One vector atomic add to global memory (sm_90's float2 / float4 atomicAdd).
template <int kV>
__device__ __forceinline__ void red_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (kV == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// s += v[row] * wgt over this lane's kV channels.
template <int kV>
__device__ __forceinline__ void add_corner(float (&s)[kV], const float* p, float wgt) {
  float v[kV];
  load_vec<kV>(p, v);
#pragma unroll
  for (int k = 0; k < kV; ++k) s[k] += v[k] * wgt;
}

template <int kV>
__global__ void __launch_bounds__(kThreads)
    msda_fwd_kernel(Problem pb, Levels lv, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int G = pb.G, j = lane & (G - 1), gbase = lane & ~(G - 1);
  int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool valid = i < pb.items;  // item (b, q, head) in memory order
  if (!valid) i = pb.items - 1;
  const int64_t bq = i / pb.H;
  const int h = static_cast<int>(i - bq * pb.H);
  const int64_t b = bq / pb.Q;
  const int n = pb.L * pb.P;
  const float* loc_i = pb.loc + i * n * 2;
  const float* attn_i = pb.attn + i * n;
  const int64_t row = static_cast<int64_t>(pb.H) * pb.D;  // stride of one token
  const float* value_bh = pb.value + b * pb.S * row + static_cast<int64_t>(h) * pb.D;

  const bool one_chunk = n <= 2 * G;
  Chunk ch = load_chunk(loc_i, attn_i, 0, n, j, valid);
  for (int cb = 0; cb < pb.ncb; ++cb) {
    const int c0 = (cb * G + j) * kV;
    const bool chan = c0 < pb.D;
    float acc[kV] = {};
    for (int l = 0; l < pb.L; ++l) {
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const float* vl = value_bh + lv.start[l] * row + c0;
      // unrolled so that the next point's corner loads start before this
      // point's sums are done
#pragma unroll 4
      for (int p = 0; p < pb.P; ++p) {
        const int si = l * pb.P + p;
        const int r = si & (2 * G - 1);
        if (!one_chunk && r == 0 && (si > 0 || cb > 0))
          ch = load_chunk(loc_i, attn_i, si, n, j, valid);
        const Sample sm = take(ch, r, gbase);
        const float x = pixel_coord(sm.x, wl);
        const float y = pixel_coord(sm.y, hl);
        if (isnan(x) || isnan(y)) {  // the plain version's NaN weights
#pragma unroll
          for (int k = 0; k < kV; ++k) acc[k] = NAN;
          continue;
        }
        // every corner of a sample outside (-1, w) x (-1, h) is padding or
        // carries a zero bilinear weight
        if (!chan || !(x > -1.f && y > -1.f && x < wl && y < hl)) continue;
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const float* v00 = vl + (static_cast<int64_t>(y0) * wl + x0) * row;
        // corners in the plain version's order: (0,0), (0,1), (1,0), (1,1)
        float s[kV] = {};
        if (y0 >= 0) {
          if (x0 >= 0) add_corner<kV>(s, v00, (1.f - fx) * (1.f - fy));
          if (x0 + 1 < wl) add_corner<kV>(s, v00 + row, fx * (1.f - fy));
        }
        if (y0 + 1 < hl) {
          const float* v10 = v00 + static_cast<int64_t>(wl) * row;
          if (x0 >= 0) add_corner<kV>(s, v10, (1.f - fx) * fy);
          if (x0 + 1 < wl) add_corner<kV>(s, v10 + row, fx * fy);
        }
#pragma unroll
        for (int k = 0; k < kV; ++k) acc[k] += s[k] * sm.a;
      }
    }
    if (valid && chan) store_vec<kV>(out + i * pb.D + c0, acc);
  }
}

// Sums (ga, gx, gy) over the G lanes of an item and stores them at entry o.
// G >= 4: a reduce-scatter of (ga, gx, gy, 0): after the rounds on lane
// bits 0 and 1, group lane 0 holds ga, lane 2 gx, lane 1 gy (each summed
// over its 4-lane quad), and the rounds on the higher bits finish the sums.
__device__ __forceinline__ void store_sample_grads(float ga, float gx, float gy, int G, int j,
                                                   bool valid, int64_t o,
                                                   float* __restrict__ grad_loc,
                                                   float* __restrict__ grad_attn) {
  if (G == 1) {
    if (valid) {
      grad_attn[o] = ga;
      grad_loc[2 * o] = gx;
      grad_loc[2 * o + 1] = gy;
    }
    return;
  }
  const bool b0 = j & 1;
  float ka = b0 ? gy : ga, kb = b0 ? 0.f : gx;  // kept: (ga, gx) or (gy, 0)
  ka += __shfl_xor_sync(kFull, b0 ? ga : gy, 1);
  kb += __shfl_xor_sync(kFull, b0 ? gx : 0.f, 1);
  if (G == 2) {
    if (valid && !b0) {
      grad_attn[o] = ka;
      grad_loc[2 * o] = kb;
    } else if (valid) {
      grad_loc[2 * o + 1] = ka;
    }
    return;
  }
  const bool b1 = j & 2;
  float v = b1 ? kb : ka;
  v += __shfl_xor_sync(kFull, b1 ? ka : kb, 2);
  for (int off = 4; off < G; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  if (valid && j < 3) {
    if (j == 0) grad_attn[o] = v;
    else if (j == 2) grad_loc[2 * o] = v;
    else grad_loc[2 * o + 1] = v;
  }
}

// Item = (b, q, head) in memory order; G * kV == D here (D a power of two
// <= 32).
template <int kV>
__global__ void __launch_bounds__(kThreads)
    msda_bwd_kernel(Problem pb, Levels lv, const float* __restrict__ grad_out,
                    float* __restrict__ grad_value, float* __restrict__ grad_loc,
                    float* __restrict__ grad_attn) {
  const int lane = threadIdx.x & 31;
  const int G = pb.G, j = lane & (G - 1), gbase = lane & ~(G - 1);
  const int c0 = j * kV;
  int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool valid = i < pb.items;
  if (!valid) i = pb.items - 1;
  const int64_t bq = i / pb.H;
  const int h = static_cast<int>(i - bq * pb.H);
  const int64_t b = bq / pb.Q;
  const int n = pb.L * pb.P;
  const float* loc_i = pb.loc + i * n * 2;
  const float* attn_i = pb.attn + i * n;
  const int64_t row = static_cast<int64_t>(pb.H) * pb.D;
  const int64_t off_bh = b * pb.S * row + static_cast<int64_t>(h) * pb.D + c0;
  const float* value_bh = pb.value + off_bh;
  float* gvalue_bh = grad_value + off_bh;
  float g[kV] = {};
  if (valid) load_vec<kV>(grad_out + i * pb.D + c0, g);

  const bool one_chunk = n <= 2 * G;
  Chunk ch = load_chunk(loc_i, attn_i, 0, n, j, valid);
  for (int l = 0; l < pb.L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float* vl = value_bh + lv.start[l] * row;
    float* gvl = gvalue_bh + lv.start[l] * row;
    for (int p = 0; p < pb.P; ++p) {
      const int si = l * pb.P + p;
      const int r = si & (2 * G - 1);
      if (!one_chunk && r == 0 && si > 0) ch = load_chunk(loc_i, attn_i, si, n, j, valid);
      const Sample sm = take(ch, r, gbase);
      const float x = pixel_coord(sm.x, wl);
      const float y = pixel_coord(sm.y, hl);
      float ga = 0.f, gx = 0.f, gy = 0.f;
      if (isnan(x) || isnan(y)) {  // the plain version's NaN weights
        ga = gx = gy = NAN;
        if (valid) {
          float bad[kV];
#pragma unroll
          for (int c = 0; c < kV; ++c) bad[c] = NAN;
          red_vec<kV>(gvl, bad);
        }
      } else if (valid && x >= -1.f && y >= -1.f && x < wl && y < hl) {
        // (outside this box every corner is padding: all gradients 0)
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
        const int64_t o00 = (static_cast<int64_t>(y0) * wl + x0) * row;
        const int64_t o10 = o00 + static_cast<int64_t>(wl) * row;
        const float *p00 = vl + o00, *p10 = vl + o10;
        float *q00 = gvl + o00, *q10 = gvl + o10;
        float v00[kV] = {}, v01[kV] = {}, v10[kV] = {}, v11[kV] = {};
        if (in_y0 && in_x0) load_vec<kV>(p00, v00);
        if (in_y0 && in_x1) load_vec<kV>(p00 + row, v01);
        if (in_y1 && in_x0) load_vec<kV>(p10, v10);
        if (in_y1 && in_x1) load_vec<kV>(p10 + row, v11);
        const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
        const float w10 = (1.f - fx) * fy, w11 = fx * fy;
        float c00[kV], c01[kV], c10[kV], c11[kV];
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          const float s = v00[c] * w00 + v01[c] * w01 + v10[c] * w10 + v11[c] * w11;
          ga += g[c] * s;
          gx += g[c] * ((v01[c] - v00[c]) * (1.f - fy) + (v11[c] - v10[c]) * fy);
          gy += g[c] * ((v10[c] - v00[c]) * (1.f - fx) + (v11[c] - v01[c]) * fx);
          const float gac = g[c] * sm.a;
          c00[c] = gac * w00;
          c01[c] = gac * w01;
          c10[c] = gac * w10;
          c11[c] = gac * w11;
        }
        gx *= sm.a * wl;
        gy *= sm.a * hl;
        if (in_y0 && in_x0) red_vec<kV>(q00, c00);
        if (in_y0 && in_x1) red_vec<kV>(q00 + row, c01);
        if (in_y1 && in_x0) red_vec<kV>(q10, c10);
        if (in_y1 && in_x1) red_vec<kV>(q10 + row, c11);
      }
      store_sample_grads(ga, gx, gy, G, j, valid, i * n + l * pb.P + p, grad_loc, grad_attn);
    }
  }
}

bool make_levels(const int64_t* level_hw, int64_t L, int64_t S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  int64_t start = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t h = level_hw[2 * l], w = level_hw[2 * l + 1];
    if (h < 1 || w < 1 || h * w > 2147483647) return false;
    lv->h[l] = static_cast<int>(h);
    lv->w[l] = static_cast<int>(w);
    lv->start[l] = start;
    start += h * w;
  }
  return start == S;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Channels per lane: 4 (16-byte accesses) where D and every channel
// pointer allow it, else 2, else 1.
int vec_width(int64_t D, const void* a, const void* b, const void* c = nullptr) {
  for (int v = 4; v > 1; v /= 2) {
    const int bytes = 4 * v;
    if (D % v == 0 && aligned(a, bytes) && aligned(b, bytes) && (!c || aligned(c, bytes)))
      return v;
  }
  return 1;
}

int pow2_at_least(int64_t x) {
  int p = 1;
  while (p < x && p < 32) p *= 2;
  return p;
}

bool make_problem(const float* value, const int64_t* level_hw, const float* loc,
                  const float* attn, int64_t S, int64_t Q, int64_t H, int64_t D, int64_t L,
                  int64_t P, int G, Problem* pb, Levels* lv) {
  pb->value = value;
  pb->loc = loc;
  pb->attn = attn;
  pb->S = S;
  pb->Q = Q;
  pb->H = static_cast<int>(H);
  pb->D = static_cast<int>(D);
  pb->L = static_cast<int>(L);
  pb->P = static_cast<int>(P);
  pb->G = G;
  return make_levels(level_hw, L, S, lv);
}

int64_t grid(int64_t items, int G) {
  const int64_t per_block = kThreads / G;
  return (items + per_block - 1) / per_block;
}

}  // namespace

// level_hw: host array of 2*L int64 (h0, w0, h1, w1, ...). All device
// tensors fp32 and contiguous; stream is a cudaStream_t.
extern "C" int msda_fwd(const float* value, const int64_t* level_hw,
                        const float* loc, const float* attn, float* out,
                        int64_t B, int64_t S, int64_t Q, int64_t H, int64_t D,
                        int64_t L, int64_t P, void* stream) {
  if (B < 0 || Q < 0 || H < 1 || D < 1 || P < 1) return RDETR_INVALID;
  const int kv = vec_width(D, value, out);
  const int G = pow2_at_least((D + kv - 1) / kv);
  Problem pb;
  Levels lv;
  if (!make_problem(value, level_hw, loc, attn, S, Q, H, D, L, P, G, &pb, &lv))
    return RDETR_INVALID;
  pb.ncb = static_cast<int>((D + G * kv - 1) / (G * kv));
  pb.items = B * Q * H;
  if (pb.items == 0) return 0;
  if (grid(pb.items, G) > 2147483647) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(grid(pb.items, G));
  if (kv == 4) msda_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(pb, lv, out);
  else if (kv == 2) msda_fwd_kernel<2><<<blocks, kThreads, 0, s>>>(pb, lv, out);
  else msda_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(pb, lv, out);
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
  if (B < 0 || Q < 0 || H < 1 || P < 1 || D < 1 || D > 32 || (D & (D - 1)) != 0)
    return RDETR_INVALID;
  const int kv = vec_width(D, value, grad_out, grad_value);
  Problem pb;
  Levels lv;
  if (!make_problem(value, level_hw, loc, attn, S, Q, H, D, L, P, static_cast<int>(D / kv),
                    &pb, &lv))
    return RDETR_INVALID;
  pb.ncb = 1;
  pb.items = B * Q * H;
  if (pb.items == 0) return 0;
  if (grid(pb.items, pb.G) > 2147483647) return RDETR_INVALID;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(grid(pb.items, pb.G));
  if (kv == 4)
    msda_bwd_kernel<4><<<blocks, kThreads, 0, s>>>(pb, lv, grad_out, grad_value, grad_loc,
                                                   grad_attn);
  else if (kv == 2)
    msda_bwd_kernel<2><<<blocks, kThreads, 0, s>>>(pb, lv, grad_out, grad_value, grad_loc,
                                                   grad_attn);
  else
    msda_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(pb, lv, grad_out, grad_value, grad_loc,
                                                   grad_attn);
  RDETR_RETURN_LAUNCH_STATUS();
}

extern "C" const char* rdetr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
