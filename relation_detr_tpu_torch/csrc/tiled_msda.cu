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
// - tiled_core_fwd keeps only the head's patch slice (M x D, 56 KB at
//   D = 32) in dynamic shared memory and sums the E entries of each token
//   directly: out[t, d] = sum_e w[e, t] * patch[m[e, t], d]. It is the
//   one-hot product with the zero terms skipped; entries whose row lies
//   outside [0, M) add nothing, as no iota row matches them on the TPU.
//   It sums in entry order where the TPU's dot sums over rows, so results
//   differ in the last bits. Bound on the card: the bytes (m, w, patch in,
//   out; 134 MB at level 0 for B = 1), 2 E flops per output element.
// - tiled_core_bwd keeps the patch slice and a dpatch slice (M x D each,
//   112 KB) in shared memory. Each (token, channel) thread adds
//   w[e, t] * g[t, d] into dpatch[m[e, t], d] with shared-memory atomics (a
//   block owns its (b, tile, head) slab, so no global atomics), and
//   dw[e, t] = sum_d patch[m[e, t], d] * g[t, d] is a shuffle reduction
//   over the D lanes that hold channel d of token t (D a power of two <= 32).
//   m gets no gradient. The atomics add in no fixed order. Bound: the bytes
//   (m, w, patch, g in, dw and dpatch out).
// - sep_contract_fwd keeps the patch slice and a chunk of A for 32 tokens
//   (M x 32, 56 KB) in shared memory: it builds the chunk from oy and ox
//   (P products per entry, read coalesced along t), then contracts it with
//   the patch (each thread one (token, channel), reading A as a warp
//   broadcast). Bound: the operations (2 P M T + 2 M T D per head) about as
//   much as the bytes (oy and ox are (ph + pw) / (ph pw) of A's size).
//
// One block per (image, tile, head), 256 threads. Every kernel launches on
// the caller's stream; the entries return cudaGetLastError().
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // tokens per A chunk in sep_contract_fwd
constexpr int64_t kMaxSmem = 232448;  // bytes a Hopper block may use

__device__ __forceinline__ void load_head_slice(float* dst, const float* patch, int M,
                                                int C, int D) {
  for (int idx = threadIdx.x; idx < M * D; idx += blockDim.x)
    dst[idx] = patch[static_cast<int64_t>(idx / D) * C + idx % D];
}

__global__ void tiled_core_fwd_kernel(const int* __restrict__ m, const float* __restrict__ w,
                                      const float* __restrict__ patch, float* __restrict__ out,
                                      int nt, int H, int E, int T, int M, int C, int D) {
  extern __shared__ float smem[];  // patch slice (M, D)
  const int h = blockIdx.y % H;
  const int64_t bn = static_cast<int64_t>(blockIdx.y / H) * nt + blockIdx.x;
  load_head_slice(smem, patch + bn * M * C + h * D, M, C, D);
  __syncthreads();
  const int* mr = m + (bn * H + h) * E * T;
  const float* wr = w + (bn * H + h) * E * T;
  float* o = out + bn * T * C + h * D;
  for (int idx = threadIdx.x; idx < T * D; idx += blockDim.x) {
    const int t = idx / D;
    const int d = idx % D;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const int row = mr[e * T + t];
      if (row >= 0 && row < M) acc += wr[e * T + t] * smem[row * D + d];
    }
    o[static_cast<int64_t>(t) * C + d] = acc;
  }
}

__global__ void tiled_core_bwd_kernel(const int* __restrict__ m, const float* __restrict__ w,
                                      const float* __restrict__ patch,
                                      const float* __restrict__ g, float* __restrict__ dw,
                                      float* __restrict__ dpatch, int nt, int H, int E, int T,
                                      int M, int C, int D) {
  extern __shared__ float smem[];  // patch slice (M, D), then dpatch slice (M, D)
  float* ps = smem;
  float* dps = smem + M * D;
  const int h = blockIdx.y % H;
  const int64_t bn = static_cast<int64_t>(blockIdx.y / H) * nt + blockIdx.x;
  load_head_slice(ps, patch + bn * M * C + h * D, M, C, D);
  for (int idx = threadIdx.x; idx < M * D; idx += blockDim.x) dps[idx] = 0.f;
  __syncthreads();
  const int* mr = m + (bn * H + h) * E * T;
  const float* wr = w + (bn * H + h) * E * T;
  const float* gr = g + bn * T * C + h * D;
  float* dwr = dw + (bn * H + h) * E * T;
  // every thread runs every round, so the shuffles see whole warps; a
  // token's D channels are D aligned lanes of one warp
  for (int base = 0; base < T * D; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const bool live = idx < T * D;
    const int t = live ? idx / D : 0;
    const int d = idx % D;
    const float gv = live ? gr[static_cast<int64_t>(t) * C + d] : 0.f;
    for (int e = 0; e < E; ++e) {
      const int row = live ? mr[e * T + t] : -1;
      const bool in = row >= 0 && row < M;
      float prod = in ? ps[row * D + d] * gv : 0.f;
      for (int off = D / 2; off > 0; off >>= 1) prod += __shfl_xor_sync(0xffffffffu, prod, off);
      if (live && d == 0) dwr[e * T + t] = prod;
      if (in) atomicAdd(&dps[row * D + d], wr[e * T + t] * gv);
    }
  }
  __syncthreads();
  float* dp = dpatch + bn * M * C + h * D;
  for (int idx = threadIdx.x; idx < M * D; idx += blockDim.x)
    dp[static_cast<int64_t>(idx / D) * C + idx % D] = dps[idx];
}

__global__ void sep_contract_fwd_kernel(const float* __restrict__ oy,
                                        const float* __restrict__ ox,
                                        const float* __restrict__ patch, float* __restrict__ out,
                                        int nt, int H, int P, int ph, int pw, int T, int C,
                                        int D) {
  extern __shared__ float smem[];  // patch slice (M, D), then A chunk (M, kChunk)
  const int M = ph * pw;
  float* ps = smem;
  float* as = smem + M * D;
  const int h = blockIdx.y % H;
  const int64_t bn = static_cast<int64_t>(blockIdx.y / H) * nt + blockIdx.x;
  load_head_slice(ps, patch + bn * M * C + h * D, M, C, D);
  const float* oyr = oy + (bn * H + h) * P * ph * T;
  const float* oxr = ox + (bn * H + h) * P * pw * T;
  float* o = out + bn * T * C + h * D;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    __syncthreads();  // the patch is staged; the last chunk's readers are done
    for (int idx = threadIdx.x; idx < M * kChunk; idx += blockDim.x) {
      const int row = idx / kChunk;
      const int tt = idx % kChunk;
      float a = 0.f;
      if (tt < tc) {
        const int y = row / pw;
        const int x = row % pw;
        for (int p = 0; p < P; ++p)
          a += oyr[(p * ph + y) * T + t0 + tt] * oxr[(p * pw + x) * T + t0 + tt];
      }
      as[idx] = a;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < tc * D; idx += blockDim.x) {
      const int tt = idx / D;
      const int d = idx % D;
      float acc = 0.f;
      for (int row = 0; row < M; ++row) acc += as[row * kChunk + tt] * ps[row * D + d];
      o[static_cast<int64_t>(t0 + tt) * C + d] = acc;
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to what this launch needs.
int allow_smem(const void* kernel, int64_t bytes) {
  if (bytes > kMaxSmem) return RDETR_INVALID;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool bad_grid(int64_t B, int64_t nt, int64_t H) {
  return B * H > 65535 || nt > 2147483647;
}

}  // namespace

// m, w (B, nt, H, E, T); patch (B, nt, M, C); out (B, nt, T, C), written whole.
extern "C" int tiled_core_fwd(const int* m, const float* w, const float* patch, float* out,
                              int64_t B, int64_t nt, int64_t H, int64_t E, int64_t T,
                              int64_t M, int64_t C, void* stream) {
  if (B * nt * T == 0) return 0;
  if (H < 1 || C % H != 0 || E < 1 || M < 1 || bad_grid(B, nt, H)) return RDETR_INVALID;
  const int64_t D = C / H;
  const int64_t smem = M * D * 4;
  const int code = allow_smem(reinterpret_cast<const void*>(tiled_core_fwd_kernel), smem);
  if (code != 0) return code;
  tiled_core_fwd_kernel<<<dim3(static_cast<unsigned>(nt), static_cast<unsigned>(B * H)),
                          kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, w, patch, out, static_cast<int>(nt), static_cast<int>(H), static_cast<int>(E),
      static_cast<int>(T), static_cast<int>(M), static_cast<int>(C), static_cast<int>(D));
  RDETR_RETURN_LAUNCH_STATUS();
}

// g (B, nt, T, C); dw (B, nt, H, E, T) and dpatch (B, nt, M, C), written
// whole. D = C / H must be a power of two <= 32.
extern "C" int tiled_core_bwd(const int* m, const float* w, const float* patch,
                              const float* g, float* dw, float* dpatch, int64_t B, int64_t nt,
                              int64_t H, int64_t E, int64_t T, int64_t M, int64_t C,
                              void* stream) {
  if (B * nt == 0) return 0;
  if (H < 1 || C % H != 0 || E < 1 || M < 1 || bad_grid(B, nt, H)) return RDETR_INVALID;
  const int64_t D = C / H;
  if (D > 32 || (D & (D - 1)) != 0) return RDETR_INVALID;
  const int64_t smem = 2 * M * D * 4;
  const int code = allow_smem(reinterpret_cast<const void*>(tiled_core_bwd_kernel), smem);
  if (code != 0) return code;
  tiled_core_bwd_kernel<<<dim3(static_cast<unsigned>(nt), static_cast<unsigned>(B * H)),
                          kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, w, patch, g, dw, dpatch, static_cast<int>(nt), static_cast<int>(H),
      static_cast<int>(E), static_cast<int>(T), static_cast<int>(M), static_cast<int>(C),
      static_cast<int>(D));
  RDETR_RETURN_LAUNCH_STATUS();
}

// oy (B, nt, H, P, ph, T), ox (B, nt, H, P, pw, T), patch (B, nt, ph * pw, C);
// out (B, nt, T, C), written whole.
extern "C" int sep_contract_fwd(const float* oy, const float* ox, const float* patch,
                                float* out, int64_t B, int64_t nt, int64_t H, int64_t P,
                                int64_t ph, int64_t pw, int64_t T, int64_t C, void* stream) {
  if (B * nt * T == 0) return 0;
  if (H < 1 || C % H != 0 || P < 1 || ph < 1 || pw < 1 || bad_grid(B, nt, H))
    return RDETR_INVALID;
  const int64_t D = C / H;
  const int64_t smem = ph * pw * (D + kChunk) * 4;
  const int code = allow_smem(reinterpret_cast<const void*>(sep_contract_fwd_kernel), smem);
  if (code != 0) return code;
  sep_contract_fwd_kernel<<<dim3(static_cast<unsigned>(nt), static_cast<unsigned>(B * H)),
                            kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      oy, ox, patch, out, static_cast<int>(nt), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(ph), static_cast<int>(pw), static_cast<int>(T), static_cast<int>(C),
      static_cast<int>(D));
  RDETR_RETURN_LAUNCH_STATUS();
}
