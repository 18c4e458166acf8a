// Tiled encoder MSDA: the per-(image, tile, head) contraction of a value
// patch against the bilinear sampling weights of the tile's T token slots.
//
// Shapes (C = H * D, M = patch rows of the level, E = 4 corners x P points):
//   m (B, nt, H, E, T) int32   patch row of each corner entry
//   w (B, nt, H, E, T) fp32    its folded weight (attention x bilinear)
//   patch (B, nt, M, C) fp32   the tile's value patch, rows y * pw + x
//   oy (B, nt, H, P, ph, T), ox (B, nt, H, P, pw, T) fp32: per-axis soft
//     one-hot vectors, A[y * pw + x, t] = sum_p oy[p, y, t] * ox[p, x, t]
//   out / g (B, nt, T, C) fp32
//
// tiled_core_fwd replaces relation_detr_tpu/ops/msda_pallas.py::_fwd_kernel
// (entry tiled_matmul_core), tiled_core_bwd its ::_bwd_kernel, and
// sep_contract_fwd relation_detr_tpu/ops/msda_sep_pallas.py::_fwd_kernel
// (entry sep_contract_fused). The TPU kernels build the dense one-hot
// matrix A_t (M, T) in VMEM and feed the MXU; at the flagship's level 0
// (M = 437, T = 128) that matrix is 224 KB, the whole of a Hopper block's
// shared memory. So:
//
// - tiled_core_fwd sums the E entries of each token directly:
//   out[t, d] = sum_e w[e, t] * patch[m[e, t], d], the one-hot product with
//   the zero terms skipped; an entry whose row lies outside [0, M) adds
//   nothing (a NaN weight on it included), as no iota row matches it on the
//   TPU. It sums in ascending e where the TPU's dot sums over rows, so
//   results differ in the last bits; and a NaN in the patch reaches only the
//   tokens with an entry on its row, where the dense product spreads it to
//   every token. Bound on the card: the bytes (m, w, patch in, out; 134 MB
//   at level 0 for B = 1, 0.040 ms), 2 E flops per output element. The
//   previous design (one block per item staging the head's patch slice, 56
//   KB at D = 32, with scalar loads, then per output element a serial loop
//   of E dependent global loads of m and w) took 0.2337 ms at level 0
//   (NVIDIA H100 80GB HBM3, 700.00 W): latency-bound. This design, after
//   tiled_core_bwd's:
//   * a persistent grid (SMs x resident blocks) of 512-thread blocks walks
//     the items (image, tile, head); cp.async 16-byte copies stage an
//     item's patch slice (M x D, rows strided by C) and its m and w (E x T
//     each), and prefetch the next item's into a second buffer while the
//     current one is computed, so no loop waits on a global load;
//   * D / 4 lanes per token slot, each a float4 of channels; the token's E
//     entries read from shared memory as broadcasts, in ascending e, and
//     its output row stored as float4s in one coalesced line. At D = 32 a
//     quarter-warp reads one whole 128-byte patch row, so the slice needs
//     no swizzle to be free of bank conflicts.
//   Shared memory 2 x (M D + 2 E T) floats: 144,640 bytes at level 0
//   (M = 437), one block per SM; 98,048 at level 1, two. A geometry whose
//   two stages exceed a block's shared memory (none of the JAX package's
//   documented tilings: tile (24, 8) on the 1216x2016 canvas needs 221,952
//   bytes) takes one stage, staging the next item after the current one is
//   computed. The design that
//   gathers patch rows through L1 instead (no staging, one 256-thread
//   block per item, entries in chunks of 8 with their loads in flight
//   together) took 0.071 ms at level 0 against this one's 0.050, and
//   ~0.066 ms at levels 1-3 against 0.034-0.040 (device time, same card).
//   D must be 4, 8, 16 or 32 and E x T a multiple of 4.
// - tiled_core_bwd: dw[e, t] = sum_d patch[m[e, t], d] * g[t, d] (0 for an
//   entry outside [0, M)) and dpatch[r, :] = sum over the entries on row r
//   of w[e, t] * g[t, :]; m gets no gradient. Bound on the card: the bytes
//   (m, w, patch, g in, dw and dpatch out: 231 MB at level 0 for B = 1,
//   0.069 ms). The previous design (one block per (image, tile, head) holding
//   the patch slice and a dpatch slab, 112 KB, so 2 blocks per SM; an inner
//   loop of broadcast global loads of m and w, a 5-step shuffle chain for
//   dw and a shared-memory atomic for dpatch per entry, nothing staged
//   ahead) took 1.5267 ms at level 0 and 0.7268 ms at level 3 (M = 156,
//   5 blocks per SM, still 20x its bound), NVIDIA H100 80GB HBM3, 700.00 W:
//   the serial, latency-bound inner loop, not occupancy. This design:
//   * a persistent grid (SMs x resident blocks) of 512-thread blocks walks
//     the work items (image, tile, head); cp.async 16-byte copies stage an
//     item's m and w (E x T), its g slice (T x D, rows strided by C) and
//     its patch slice (M x D), and prefetch the next item's into a second
//     buffer while the current one is computed, so no loop waits on a
//     global load;
//   * dw: four threads per token slot t, each holding g[t, :] in
//     registers and taking every fourth of the token's entries: D FMAs per
//     entry from shared memory in float4 reads, no shuffles. The staged
//     slices are XOR-swizzled in 16-byte chunks (chunk a sits at
//     a ^ ((a >> 3) & 7)), so the D = 32 float rows that the lanes of a
//     warp read at the same column fall in distinct banks;
//   * dpatch: a gather, not a scatter. The item's entries are
//     counting-sorted by patch row in shared memory (a histogram per row
//     and warp partition, an exclusive scan, then each warp places its
//     partition's entries in ascending (e, t) with __match_any_sync ranks),
//     so each row's entries lie in ascending (e, t); D / 4 lanes per row,
//     a float4 of channels each (four rows per warp at D = 32), then sum
//     w * g[t, :] in that order and store the row to dpatch in one
//     coalesced 128-byte line. No float atomics remain, dpatch and dw are
//     deterministic (two launches give the same bits), and a row that no
//     entry hits is written as 0.
//   Shared memory: 2 x (M + T) x D + 4 E T floats of staging, 16 M ints of
//   histogram and E T (weight, token) pairs: 221,888 bytes at level 0
//   (M = 437), so one block of 16 warps per SM. Three blocks per SM would
//   need 75 KB each, less than one item's staging (88.7 KB at level 0);
//   the second buffer's overlap of loads with compute is taken over the
//   occupancy. Where two stages do not fit (the larger tiles, halos and
//   margins of the JAX package's settings: tile (16, 8) at M = 494, T = 160
//   needs 260,608 bytes, halos of 8 at M = 725 314,048), the kernel takes
//   one stage and stages the next item after the current one is computed,
//   so its loads no longer overlap compute: 212,672 bytes at the largest,
//   tile (24, 8) on the 1216x2016 canvas (M = 627, T = 240). A geometry
//   that one stage does not fit raises. D = C / H must be 4, 8, 16 or 32
//   (16-byte chunks, D / 4 lanes per dpatch row) and E x T a multiple of
//   4.
// - sep_contract_fwd: per (image, tile, head) the small GEMM out (T x D) =
//   A^T (T x M) patch (M x D), K = M <= 437, with A = sum_p oy_p (x) ox_p
//   built on the fly. Bound on the card: the operations (P + D FMAs per
//   A element: 2 P M T + 2 M T D per item, 0.091 ms at level 0 for B = 1)
//   about as much as the bytes (oy, ox, patch, out: 0.071 ms). The previous
//   design (one 256-thread block per item holding the patch slice and a
//   32-token chunk of A, each A element built from global loads of oy and
//   ox, each output one thread with a serial loop over all M rows, two
//   shared-memory loads per FMA) took 1.46 ms at level 0 (NVIDIA H100
//   80GB HBM3, 700.00 W), 6% of the fp32 rate: bound by shared memory.
//   This design, 256 threads per item:
//   * the patch slice (M x D) is staged once with cp.async; ox for the
//     block's 128 token slots sits in registers (two threads per slot,
//     taking the even and the odd patch columns, at most 10 each, P <= 4
//     points; a patch wider than 20 takes the kernel's form with 16 each,
//     one block per SM), and oy for the next chunk's patch rows is loaded into
//     registers while the current chunk is contracted;
//   * A is built in chunks of whole patch rows y (ky = 40 / pw rows, at
//     most 4) into two shared buffers of 40 x 128: each element P FMAs
//     from registers and one store, coalesced along the token slots; the
//     next chunk is built while other warps may still read this one, so
//     one barrier per chunk;
//   * the contraction is register-tiled: each thread 4 tokens x 4
//     channels, one float4 of A and one of the patch per row (two
//     shared-memory wavefronts per warp for 16 FMAs), rows in ascending
//     order. Shared memory 96,896 bytes at level 0 (M = 437, D = 32), two
//     blocks per SM. D must be 4, 8, 16 or 32, pw <= 32 (the default tiling
//     gives pw <= 19: 8 columns per tile, halos of 5, a margin of 1; tile
//     (12, 10) gives 21, halos of 8 give 25).
//
// Every kernel launches on the caller's stream; the entries return
// cudaGetLastError().
#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int64_t kMaxSmem = 232448;  // bytes a Hopper block may use

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int64_t round_up(int64_t v, int64_t to) {
  return (v + to - 1) / to * to;
}

// --- tiled_core_fwd ------------------------------------------------------------

struct FwdShape {
  int64_t items;  // B * nt * H
  int H, E, T, M, C, ET;
  int ps_floats;  // the staged patch slice, M x D
  int stages;     // stage buffers: 2 (prefetch the next item) or 1
};

constexpr int kFwdThreads = 512;

// Starts the cp.async copies of one item's patch slice, m and w into a
// stage buffer.
template <int DQ>
__device__ void fwd_stage(float* buf, const FwdShape& s, int64_t item, const int* m,
                          const float* w, const float* patch) {
  constexpr int D = DQ * 4;
  const int64_t bn = item / s.H;
  const int h = static_cast<int>(item - bn * s.H);
  float* ms = buf + s.ps_floats;
  float* ws = ms + s.ET;
  const float* pg = patch + bn * s.M * s.C + h * D;
  for (int i = threadIdx.x; i < s.M * DQ; i += kFwdThreads)
    cp_async16(buf + i * 4, pg + static_cast<int64_t>(i / DQ) * s.C + (i % DQ) * 4);
  const int* mm = m + item * s.ET;
  const float* wm = w + item * s.ET;
  for (int i = threadIdx.x; i < s.ET / 4; i += kFwdThreads) {
    cp_async16(ms + i * 4, mm + i * 4);
    cp_async16(ws + i * 4, wm + i * 4);
  }
}

// The persistent grid walks the items (image, tile, head): each item's
// operands are staged while the previous one is computed; D / 4 lanes per
// token slot, a float4 of channels each, entries in ascending e.
template <int DQ>
__global__ void __launch_bounds__(kFwdThreads, 1)
    tiled_core_fwd_kernel(const int* __restrict__ m, const float* __restrict__ w,
                          const float* __restrict__ patch, float* __restrict__ out,
                          FwdShape s) {
  constexpr int D = 4 * DQ;
  constexpr int kTokens = kFwdThreads / DQ;  // token slots per pass
  extern __shared__ __align__(16) float smem[];  // two stage buffers
  const int stage = s.ps_floats + 2 * s.ET;
  const int q = threadIdx.x % DQ;
  int64_t item = blockIdx.x;
  fwd_stage<DQ>(smem, s, item, m, w, patch);  // the grid has at most s.items blocks
  cp_async_commit();
  for (int k = 0; item < s.items; item += gridDim.x, ++k) {
    // two stages: prefetch the next item into the other buffer, then wait
    // for this one; one stage: wait for this one, stage the next after it
    const int64_t next = item + gridDim.x;
    const bool two = s.stages == 2;
    if (two) {
      if (next < s.items) fwd_stage<DQ>(smem + ((k + 1) & 1) * stage, s, next, m, w, patch);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = smem + (two ? (k & 1) * stage : 0);
    const float4* ps = reinterpret_cast<const float4*>(buf) + q;  // row r at ps[r * DQ]
    const int* ms = reinterpret_cast<const int*>(buf + s.ps_floats);
    const float* ws = buf + s.ps_floats + s.ET;
    const int64_t bn = item / s.H;
    const int h = static_cast<int>(item - bn * s.H);
    float4* og = reinterpret_cast<float4*>(out + bn * s.T * s.C + h * D) + q;
    for (int t = threadIdx.x / DQ; t < s.T; t += kTokens) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int e = 0; e < s.E; ++e) {
        const int r = ms[e * s.T + t];
        if (static_cast<unsigned>(r) < static_cast<unsigned>(s.M))
          fma4(acc, ws[e * s.T + t], ps[r * DQ]);
      }
      og[static_cast<int64_t>(t) * (s.C / 4)] = acc;
    }
    __syncthreads();  // the buffer is free for the next stage
    if (!two && next < s.items) {
      fwd_stage<DQ>(smem, s, next, m, w, patch);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// The stage buffers of the patch slice, m and w.
int64_t fwd_smem_bytes(const FwdShape& s) {
  return s.stages * (static_cast<int64_t>(s.ps_floats) + 2 * s.ET) * 4;
}

// --- tiled_core_bwd ------------------------------------------------------------

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct BwdEntry {  // a sorted entry: its weight and token slot
  float w;
  int t;
};

constexpr int kDwSplit = 4;  // dw threads per token slot

// The swizzled position of 16-byte chunk a of a staged slice.
__device__ __forceinline__ int swz(int a) { return a ^ ((a >> 3) & 7); }

struct BwdShape {
  int64_t items;  // B * nt * H
  int H, E, T, M, C, ET;
  int ps_floats, gs_floats;  // swizzled slices, whole 128-byte lines
  int stage_floats;          // patch slice, g slice, m, w
  int hist_ints;
  int stages;                // stage buffers: 2 (prefetch the next item) or 1
};

BwdShape bwd_shape(int64_t B, int64_t nt, int64_t H, int64_t E, int64_t T, int64_t M,
                   int64_t C) {
  BwdShape s;
  const int64_t D = C / H;
  s.items = B * nt * H;
  s.H = static_cast<int>(H);
  s.E = static_cast<int>(E);
  s.T = static_cast<int>(T);
  s.M = static_cast<int>(M);
  s.C = static_cast<int>(C);
  s.ET = static_cast<int>(E * T);
  s.ps_floats = static_cast<int>(round_up(M * D, 32));
  s.gs_floats = static_cast<int>(round_up(T * D, 32));
  s.stage_floats = s.ps_floats + s.gs_floats + 2 * s.ET;
  s.hist_ints = static_cast<int>(round_up(M * kBwdWarps, 4));  // then 32 ints of scan scratch
  s.stages = 2;
  return s;
}

// The stage buffers, the histogram, the scan scratch and the sorted entries.
int64_t bwd_smem_bytes(const BwdShape& s) {
  return (s.stages * static_cast<int64_t>(s.stage_floats) + s.hist_ints + 32) * 4 +
         static_cast<int64_t>(s.ET) * sizeof(BwdEntry);
}

// Starts the cp.async copies of one item's operands into a stage buffer.
template <int DQ>
__device__ void bwd_stage(float* buf, const BwdShape& s, int64_t item, const int* m,
                          const float* w, const float* patch, const float* g) {
  constexpr int D = DQ * 4;
  const int64_t bn = item / s.H;
  const int h = static_cast<int>(item - bn * s.H);
  float* ps = buf;
  float* gs = ps + s.ps_floats;
  float* ms = gs + s.gs_floats;
  float* ws = ms + s.ET;
  const float* pg = patch + bn * s.M * s.C + h * D;
  for (int i = threadIdx.x; i < s.M * DQ; i += kBwdThreads)
    cp_async16(ps + swz(i) * 4, pg + static_cast<int64_t>(i / DQ) * s.C + (i % DQ) * 4);
  const float* gg = g + bn * s.T * s.C + h * D;
  for (int i = threadIdx.x; i < s.T * DQ; i += kBwdThreads)
    cp_async16(gs + swz(i) * 4, gg + static_cast<int64_t>(i / DQ) * s.C + (i % DQ) * 4);
  const int* mm = m + item * s.ET;
  const float* wm = w + item * s.ET;
  for (int i = threadIdx.x; i < s.ET / 4; i += kBwdThreads) {
    cp_async16(ms + i * 4, mm + i * 4);
    cp_async16(ws + i * 4, wm + i * 4);
  }
}

// Exclusive prefix sum of a[0, n) in shared memory, in index order; n and
// a's offset multiples of 4 ints (each thread scans a run of int4s).
__device__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int4* a4 = reinterpret_cast<int4*>(a);
  const int n4 = n / 4;
  const int per = (n4 + kBwdThreads - 1) / kBwdThreads;
  const int lo = min(n4, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n4, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) {
    const int4 c = a4[i];
    sum += c.x + c.y + c.z + c.w;
  }
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kBwdWarps ? warp_sums[lane] : 0;
    int vi = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, vi, off);
      if (lane >= off) vi += y;
    }
    if (lane < kBwdWarps) warp_sums[lane] = vi - v;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int4 c = a4[i];
    int4 o;
    o.x = run;
    o.y = o.x + c.x;
    o.z = o.y + c.y;
    o.w = o.z + c.z;
    run = o.w + c.w;
    a4[i] = o;
  }
  __syncthreads();
}

// One item's dw and dpatch from its staged operands. Ends with the block
// synchronised, so the stage buffer, histogram and sorted entries are free.
template <int DQ>
__device__ void bwd_compute(const float* buf, int* hist, BwdEntry* sorted, int* warp_sums,
                            const BwdShape& s, int64_t item, float* dw, float* dpatch) {
  constexpr int D = DQ * 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* ps = reinterpret_cast<const float4*>(buf);
  const float4* gs = reinterpret_cast<const float4*>(buf + s.ps_floats);
  const int* ms = reinterpret_cast<const int*>(buf + s.ps_floats + s.gs_floats);
  const float* ws = buf + s.ps_floats + s.gs_floats + s.ET;
  const int M = s.M;
  const int ET = s.ET;
  // warp p places the entries [p * part, (p + 1) * part), ascending
  const int part = (ET + kBwdWarps - 1) / kBwdWarps;

  for (int i = threadIdx.x; i < s.hist_ints; i += kBwdThreads) hist[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < ET; j += kBwdThreads) {
    const int r = ms[j];
    if (r >= 0 && r < M) atomicAdd(&hist[r * kBwdWarps + j / part], 1);
  }
  __syncthreads();
  // (row, partition) order: a row's entries from partition p come before
  // those from p + 1, and so in ascending (e, t)
  block_exclusive_scan(hist, M * kBwdWarps, warp_sums);

  const int j1 = min(ET, (warp + 1) * part);
  for (int base = warp * part; base < j1; base += 32) {
    const int j = base + lane;
    int r = j < j1 ? ms[j] : -1;
    if (r < 0 || r >= M) r = -1;
    const unsigned peers = __match_any_sync(kFullMask, r);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    int slot = 0;
    if (r >= 0) {
      slot = hist[r * kBwdWarps + warp];
      const int e = j / s.T;
      sorted[slot + rank] = BwdEntry{ws[j], j - e * s.T};
    }
    __syncwarp();
    if (r >= 0 && rank == 0) hist[r * kBwdWarps + warp] = slot + __popc(peers);
    __syncwarp();
  }
  // hist[r * kBwdWarps + kBwdWarps - 1] is now the end of row r's entries

  // dw: kDwSplit threads per token slot t, each with g[t, :] in registers,
  // taking the entries e = q, q + kDwSplit, ... of its token
  float* dwr = dw + item * ET;
  for (int u = threadIdx.x; u < s.T * kDwSplit; u += kBwdThreads) {
    const int t = u / kDwSplit;
    float4 gv[DQ];
#pragma unroll
    for (int q = 0; q < DQ; ++q) gv[q] = gs[swz(t * DQ + q)];
#pragma unroll 2
    for (int e = u % kDwSplit; e < s.E; e += kDwSplit) {
      const int j = e * s.T + t;
      const int r = ms[j];
      float acc = 0.f;
      if (r >= 0 && r < M) {
#pragma unroll
        for (int q = 0; q < DQ; ++q) {
          const float4 p = ps[swz(r * DQ + q)];
          acc = fmaf(p.x, gv[q].x, acc);
          acc = fmaf(p.y, gv[q].y, acc);
          acc = fmaf(p.z, gv[q].z, acc);
          acc = fmaf(p.w, gv[q].w, acc);
        }
      }
      dwr[j] = acc;
    }
  }
  __syncthreads();

  // dpatch: DQ lanes per row, a float4 of channels each, 32 / DQ rows per
  // warp at a time
  constexpr int kRowsPerWarp = 32 / DQ;
  const int q = lane % DQ;
  const int64_t bn = item / s.H;
  const int h = static_cast<int>(item - bn * s.H);
  float4* dp = reinterpret_cast<float4*>(dpatch + bn * M * s.C + h * D) + q;
  for (int r = warp * kRowsPerWarp + lane / DQ; r < M; r += kBwdWarps * kRowsPerWarp) {
    const int beg = r > 0 ? hist[r * kBwdWarps - 1] : 0;
    const int end = hist[r * kBwdWarps + kBwdWarps - 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int k = beg;
    for (; k + 4 <= end; k += 4) {
      BwdEntry en[4];
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) en[u] = sorted[k + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = gs[swz(en[u].t * DQ + q)];
#pragma unroll
      for (int u = 0; u < 4; ++u) fma4(acc, en[u].w, v[u]);
    }
    for (; k < end; ++k) {
      const BwdEntry en = sorted[k];
      fma4(acc, en.w, gs[swz(en.t * DQ + q)]);
    }
    dp[static_cast<int64_t>(r) * (s.C / 4)] = acc;
  }
  __syncthreads();
}

template <int DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
    tiled_core_bwd_kernel(const int* __restrict__ m, const float* __restrict__ w,
                          const float* __restrict__ patch, const float* __restrict__ g,
                          float* __restrict__ dw, float* __restrict__ dpatch, BwdShape s) {
  extern __shared__ __align__(16) float smem[];  // stage buffers, hist, scan scratch, sorted
  int* hist = reinterpret_cast<int*>(smem + s.stages * s.stage_floats);
  int* warp_sums = hist + s.hist_ints;
  BwdEntry* sorted = reinterpret_cast<BwdEntry*>(warp_sums + 32);
  int64_t item = blockIdx.x;
  bwd_stage<DQ>(smem, s, item, m, w, patch, g);  // the grid has at most s.items blocks
  cp_async_commit();
  for (int k = 0; item < s.items; item += gridDim.x, ++k) {
    // two stages: prefetch the next item into the other buffer, then wait
    // for this one; one stage: wait for this one, stage the next after it
    const int64_t next = item + gridDim.x;
    const bool two = s.stages == 2;
    if (two) {
      if (next < s.items)
        bwd_stage<DQ>(smem + ((k + 1) & 1) * s.stage_floats, s, next, m, w, patch, g);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bwd_compute<DQ>(smem + (two ? (k & 1) * s.stage_floats : 0), hist, sorted, warp_sums, s,
                    item, dw, dpatch);  // ends synchronised: the buffer is free
    if (!two && next < s.items) {
      bwd_stage<DQ>(smem, s, next, m, w, patch, g);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// --- sep_contract_fwd ----------------------------------------------------------

constexpr int kSepThreads = 256;
constexpr int kSepTokens = 128;     // token slots per pass, one per build thread pair
constexpr int kSepChunkRows = 40;   // most A rows per chunk (whole patch rows y)
constexpr int kSepMaxKy = 4;        // most patch rows y per chunk
// patch columns per build thread, a template argument: pw <= 2 x 10, or
// pw <= 2 x 16 (the wider halos and tiles; one block per SM's registers)
constexpr int kSepXSlotsNarrow = 10;
constexpr int kSepXSlotsWide = 16;
constexpr int kSepMaxP = 4;         // points per level

struct SepShape {
  int H, P, ph, pw, T, C, M, ky;
  int ps_floats;  // the staged patch slice, M x D
};

// Loads the soft one-hot rows y0 .. y0 + ky - 1 of token t (0 past ph, P
// or T) into registers.
__device__ __forceinline__ void sep_load_oy(float (&oyv)[kSepMaxKy][kSepMaxP], const float* oyr,
                                            const SepShape& s, int y0, int t, bool tv) {
#pragma unroll
  for (int yy = 0; yy < kSepMaxKy; ++yy)
#pragma unroll
    for (int p = 0; p < kSepMaxP; ++p) {
      const int y = y0 + yy;
      oyv[yy][p] = (tv && yy < s.ky && y < s.ph && p < s.P)
                       ? oyr[(static_cast<int64_t>(p) * s.ph + y) * s.T + t] : 0.f;
    }
}

// Builds A chunk rows (y - y0) pw + x for this thread's token slot and
// columns x = xh, xh + 2, ...: A = sum_p oy[p, y, t] ox[p, x, t].
template <int XS>
__device__ __forceinline__ void sep_build(float* a, const float (&oyv)[kSepMaxKy][kSepMaxP],
                                          const float (&oxv)[kSepMaxP][XS],
                                          const SepShape& s, int y0, int tl, int xh) {
  const int ny = min(s.ky, s.ph - y0);
#pragma unroll
  for (int yy = 0; yy < kSepMaxKy; ++yy) {
    if (yy >= ny) break;
#pragma unroll
    for (int i = 0; i < XS; ++i) {
      const int x = xh + 2 * i;
      if (x >= s.pw) break;
      float v = oyv[yy][0] * oxv[0][i];
#pragma unroll
      for (int p = 1; p < kSepMaxP; ++p) v = fmaf(oyv[yy][p], oxv[p][i], v);
      a[(yy * s.pw + x) * kSepTokens + tl] = v;
    }
  }
}

// One block per (image, tile, head): out (T x D) = A^T (T x M) patch (M x D)
// as a small GEMM over K = M, A built chunk by chunk (see the header).
template <int DQ, int XS>
__global__ void __launch_bounds__(kSepThreads, XS <= kSepXSlotsNarrow ? 2 : 1)
    sep_contract_fwd_kernel(const float* __restrict__ oy, const float* __restrict__ ox,
                            const float* __restrict__ patch, float* __restrict__ out,
                            SepShape s) {
  constexpr int D = 4 * DQ;
  extern __shared__ __align__(16) float smem[];  // patch slice, then two A chunks
  float* ps = smem;
  float* as = smem + s.ps_floats;
  const int tid = threadIdx.x;
  const int64_t item = blockIdx.x;
  const int64_t bn = item / s.H;
  const int h = static_cast<int>(item - bn * s.H);
  const float* pg = patch + bn * s.M * s.C + h * D;
  for (int i = tid; i < s.M * DQ; i += kSepThreads)
    cp_async16(ps + i * 4, pg + static_cast<int64_t>(i / DQ) * s.C + (i % DQ) * 4);
  cp_async_commit();
  const float* oyr = oy + item * s.P * s.ph * s.T;
  const float* oxr = ox + item * s.P * s.pw * s.T;
  const int tl = tid % kSepTokens;  // build: token slot and column parity
  const int xh = tid / kSepTokens;
  const int tg = tid / DQ;  // contraction: tokens 4 tg .. 4 tg + 3, channels 4 dg .. 4 dg + 3
  const int dg = tid % DQ;
  const bool active = tg < kSepTokens / 4;
  const int nchunks = (s.ph + s.ky - 1) / s.ky;
  const float4* ps4 = reinterpret_cast<const float4*>(ps);
  for (int t0 = 0; t0 < s.T; t0 += kSepTokens) {
    const int t = t0 + tl;
    const bool tv = t < s.T;
    float oxv[kSepMaxP][XS];
#pragma unroll
    for (int p = 0; p < kSepMaxP; ++p)
#pragma unroll
      for (int i = 0; i < XS; ++i) {
        const int x = xh + 2 * i;
        oxv[p][i] = (tv && x < s.pw && p < s.P)
                        ? oxr[(static_cast<int64_t>(p) * s.pw + x) * s.T + t] : 0.f;
      }
    float oyv[kSepMaxKy][kSepMaxP];
    sep_load_oy(oyv, oyr, s, 0, t, tv);
    sep_build<XS>(as, oyv, oxv, s, 0, tl, xh);
    float4 acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < nchunks; ++k) {
      // prefetch the next chunk's oy rows, contract this chunk, then build
      // the next one into the other buffer while this one may still be read
      const bool more = k + 1 < nchunks;
      if (more) sep_load_oy(oyv, oyr, s, (k + 1) * s.ky, t, tv);
      if (active) {
        const int rows = min(s.ky, s.ph - k * s.ky) * s.pw;
        const float4* a4 = reinterpret_cast<const float4*>(as + (k & 1) * kSepChunkRows *
                                                           kSepTokens) + tg;
        const float4* p4 = ps4 + static_cast<int64_t>(k) * s.ky * s.pw * DQ + dg;
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
          const float4 a = a4[r * (kSepTokens / 4)];
          const float4 p = p4[r * DQ];
          fma4(acc[0], a.x, p);
          fma4(acc[1], a.y, p);
          fma4(acc[2], a.z, p);
          fma4(acc[3], a.w, p);
        }
      }
      if (more)
        sep_build<XS>(as + ((k + 1) & 1) * kSepChunkRows * kSepTokens, oyv, oxv, s,
                  (k + 1) * s.ky, tl, xh);
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = t0 + 4 * tg + u;
        if (tt < s.T)
          reinterpret_cast<float4*>(out + (bn * s.T + tt) * s.C + h * D)[dg] = acc[u];
      }
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to what this launch needs.
int allow_smem(const void* kernel, int64_t bytes) {
  if (bytes > kMaxSmem) return RDETR_INVALID;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The persistent grid's blocks for a kernel of `threads` threads whose
// launch needs smem bytes: SMs x the blocks that fit on one. Worked out once
// per device, kernel and size, and the kernel's shared-memory limit raised
// to the most a block may use at the first, so a launch after the first
// makes no attribute or occupancy query.
int grid_blocks(const void* kernel, int threads, int64_t smem, int64_t* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int64_t>, int64_t> known;
  int device = 0;
  int code = static_cast<int>(cudaGetDevice(&device));
  if (code != 0) return code;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({device, kernel, smem});
  if (it != known.end()) {
    *blocks = it->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  code = allow_smem(kernel, kMaxSmem);
  if (code == 0)
    code = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (code == 0)
    code = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, static_cast<size_t>(smem)));
  if (code != 0) return code;
  if (per_sm < 1) return RDETR_INVALID;
  *blocks = known[{device, kernel, smem}] = static_cast<int64_t>(sms) * per_sm;
  return 0;
}

template <int DQ>
int launch_tiled_core_fwd(const int* m, const float* w, const float* patch, float* out,
                          const FwdShape& s, cudaStream_t stream) {
  const int64_t smem = fwd_smem_bytes(s);
  int64_t blocks = 0;
  const int code = grid_blocks(reinterpret_cast<const void*>(tiled_core_fwd_kernel<DQ>),
                               kFwdThreads, smem, &blocks);
  if (code != 0) return code;
  const int64_t grid = std::min(s.items, blocks);
  tiled_core_fwd_kernel<DQ><<<static_cast<unsigned>(grid), kFwdThreads, smem, stream>>>(
      m, w, patch, out, s);
  RDETR_RETURN_LAUNCH_STATUS();
}

template <int DQ>
int launch_tiled_core_bwd(const int* m, const float* w, const float* patch, const float* g,
                          float* dw, float* dpatch, const BwdShape& s, cudaStream_t stream) {
  const int64_t smem = bwd_smem_bytes(s);
  int64_t blocks = 0;
  const int code = grid_blocks(reinterpret_cast<const void*>(tiled_core_bwd_kernel<DQ>),
                               kBwdThreads, smem, &blocks);
  if (code != 0) return code;
  const int64_t grid = std::min(s.items, blocks);
  tiled_core_bwd_kernel<DQ><<<static_cast<unsigned>(grid), kBwdThreads, smem, stream>>>(
      m, w, patch, g, dw, dpatch, s);
  RDETR_RETURN_LAUNCH_STATUS();
}

template <int DQ, int XS>
int launch_sep_contract_xs(const float* oy, const float* ox, const float* patch, float* out,
                           int64_t items, const SepShape& s, cudaStream_t stream) {
  const int64_t smem = (s.ps_floats + 2 * kSepChunkRows * kSepTokens) * 4;
  const int code =
      allow_smem(reinterpret_cast<const void*>(sep_contract_fwd_kernel<DQ, XS>), smem);
  if (code != 0) return code;
  sep_contract_fwd_kernel<DQ, XS><<<static_cast<unsigned>(items), kSepThreads, smem, stream>>>(
      oy, ox, patch, out, s);
  RDETR_RETURN_LAUNCH_STATUS();
}

template <int DQ>
int launch_sep_contract(const float* oy, const float* ox, const float* patch, float* out,
                        int64_t items, const SepShape& s, cudaStream_t stream) {
  if (s.pw <= 2 * kSepXSlotsNarrow)
    return launch_sep_contract_xs<DQ, kSepXSlotsNarrow>(oy, ox, patch, out, items, s, stream);
  return launch_sep_contract_xs<DQ, kSepXSlotsWide>(oy, ox, patch, out, items, s, stream);
}

}  // namespace

// m, w (B, nt, H, E, T); patch (B, nt, M, C); out (B, nt, T, C), written
// whole. D = C / H must be 4, 8, 16 or 32, E * T a multiple of 4 and every
// pointer 16-byte aligned.
extern "C" int tiled_core_fwd(const int* m, const float* w, const float* patch, float* out,
                              int64_t B, int64_t nt, int64_t H, int64_t E, int64_t T,
                              int64_t M, int64_t C, void* stream) {
  if (B * nt * H * T == 0) return 0;
  if (H < 1 || C % H != 0 || E < 1 || M < 1 || (E * T) % 4 != 0) return RDETR_INVALID;
  if (E * T > (1 << 24) || M * C > (1 << 30) || T * C > (1 << 30)) return RDETR_INVALID;
  for (const void* p : {static_cast<const void*>(m), static_cast<const void*>(w),
                        static_cast<const void*>(patch), static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return RDETR_INVALID;
  FwdShape s;
  s.items = B * nt * H;
  s.H = static_cast<int>(H);
  s.E = static_cast<int>(E);
  s.T = static_cast<int>(T);
  s.M = static_cast<int>(M);
  s.C = static_cast<int>(C);
  s.ET = static_cast<int>(E * T);
  s.ps_floats = static_cast<int>(round_up(M * (C / H), 4));
  s.stages = 2;
  if (fwd_smem_bytes(s) > kMaxSmem) s.stages = 1;
  if (fwd_smem_bytes(s) > kMaxSmem) return RDETR_INVALID;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 4: return launch_tiled_core_fwd<1>(m, w, patch, out, s, st);
    case 8: return launch_tiled_core_fwd<2>(m, w, patch, out, s, st);
    case 16: return launch_tiled_core_fwd<4>(m, w, patch, out, s, st);
    case 32: return launch_tiled_core_fwd<8>(m, w, patch, out, s, st);
    default: return RDETR_INVALID;
  }
}

// g (B, nt, T, C); dw (B, nt, H, E, T) and dpatch (B, nt, M, C), written
// whole. D = C / H must be 4, 8, 16 or 32, E * T a multiple of 4 and every
// pointer 16-byte aligned.
extern "C" int tiled_core_bwd(const int* m, const float* w, const float* patch,
                              const float* g, float* dw, float* dpatch, int64_t B, int64_t nt,
                              int64_t H, int64_t E, int64_t T, int64_t M, int64_t C,
                              void* stream) {
  if (B * nt * H == 0) return 0;
  if (H < 1 || C % H != 0 || E < 1 || T < 1 || M < 1 || (E * T) % 4 != 0) return RDETR_INVALID;
  if (E * T > (1 << 24) || M * kBwdWarps > (1 << 24) || C > (1 << 24)) return RDETR_INVALID;
  for (const void* p : {static_cast<const void*>(m), static_cast<const void*>(w),
                        static_cast<const void*>(patch), static_cast<const void*>(g),
                        static_cast<const void*>(dpatch)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return RDETR_INVALID;
  BwdShape s = bwd_shape(B, nt, H, E, T, M, C);
  if (bwd_smem_bytes(s) > kMaxSmem) s.stages = 1;
  if (bwd_smem_bytes(s) > kMaxSmem) return RDETR_INVALID;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 4: return launch_tiled_core_bwd<1>(m, w, patch, g, dw, dpatch, s, st);
    case 8: return launch_tiled_core_bwd<2>(m, w, patch, g, dw, dpatch, s, st);
    case 16: return launch_tiled_core_bwd<4>(m, w, patch, g, dw, dpatch, s, st);
    case 32: return launch_tiled_core_bwd<8>(m, w, patch, g, dw, dpatch, s, st);
    default: return RDETR_INVALID;
  }
}

// oy (B, nt, H, P, ph, T), ox (B, nt, H, P, pw, T), patch (B, nt, ph * pw, C);
// out (B, nt, T, C), written whole. D = C / H must be 4, 8, 16 or 32, P at
// most 4, pw at most 32, and patch and out 16-byte aligned.
extern "C" int sep_contract_fwd(const float* oy, const float* ox, const float* patch,
                                float* out, int64_t B, int64_t nt, int64_t H, int64_t P,
                                int64_t ph, int64_t pw, int64_t T, int64_t C, void* stream) {
  if (B * nt * T == 0) return 0;
  if (H < 1 || C % H != 0 || P < 1 || P > kSepMaxP || ph < 1 || pw < 1 ||
      pw > 2 * kSepXSlotsWide || T > (1 << 24) || ph > (1 << 24))
    return RDETR_INVALID;
  const int64_t items = B * nt * H;
  if (items > 2147483647) return RDETR_INVALID;
  if (reinterpret_cast<uintptr_t>(patch) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return RDETR_INVALID;
  SepShape s;
  s.H = static_cast<int>(H);
  s.P = static_cast<int>(P);
  s.ph = static_cast<int>(ph);
  s.pw = static_cast<int>(pw);
  s.T = static_cast<int>(T);
  s.C = static_cast<int>(C);
  s.M = static_cast<int>(ph * pw);
  s.ky = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(kSepMaxKy, kSepChunkRows / pw)));
  s.ps_floats = static_cast<int>(round_up(ph * pw * (C / H), 4));
  if ((s.ps_floats + 2 * kSepChunkRows * kSepTokens) * 4 > kMaxSmem) return RDETR_INVALID;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 4: return launch_sep_contract<1>(oy, ox, patch, out, items, s, st);
    case 8: return launch_sep_contract<2>(oy, ox, patch, out, items, s, st);
    case 16: return launch_sep_contract<4>(oy, ox, patch, out, items, s, st);
    case 32: return launch_sep_contract<8>(oy, ox, patch, out, items, s, st);
    default: return RDETR_INVALID;
  }
}
