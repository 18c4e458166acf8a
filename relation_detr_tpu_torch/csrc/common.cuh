// Shared pieces of the package's CUDA kernels (plain C interface, no
// PyTorch headers: the library is built by nvcc alone and loaded with
// ctypes, see relation_detr_tpu_torch/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Every C entry returns a cudaError_t as int: cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() right after
// the launch (a refused launch never runs, and a later synchronize does not
// report it).
#define RDETR_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
#define RDETR_INVALID static_cast<int>(cudaErrorInvalidValue)

// sin(x) and cos(x) from one argument reduction, for the relation kernels'
// angles (relation_bias.cu, relation_bias_rel.cu): q = rint(x 2 / pi) (by
// the 1.5 x 2^23 shift) and r = x - q pi / 2 in two FMA steps against
// pi / 2 = C1 + C2 (C1 the fp32 pi / 2; the dropped remainder is 1.8e-15, so
// q * 1.8e-15 < 1e-11 rad for |x| < 1e4), then the minimax polynomials of
// Cephes's sinf and cosf on |r| <= pi / 4. Its error against float64 is at
// most 1.5e-7 over [-9e3, 9e3] rad, as tests/test_torch_kernel_schedule.py
// holds (the accurate sinf: ~4e-8); the accurate sinf and cosf each do their
// own reduction and carry a slow path, and the fast __sinf / __cosf on the
// unreduced angle lose accuracy at these angles. NaN and Inf give NaN.
static __device__ __forceinline__ void sincos_rr(float x, float* s, float* c) {
  // q = rint(x 2 / pi) by the 1.5 * 2^23 shift (no conversion instruction);
  // its low two bits are the quadrant, for negative q too
  const float t = fmaf(x, 0.636619772f, 0x1.8p+23f);
  const float q = t - 0x1.8p+23f;
  float r = fmaf(q, -0x1.921fb6p+0f, x);
  r = fmaf(q, 0x1.777a5cp-25f, r);
  const float z = r * r;
  float ps = fmaf(z, -1.9515295891e-4f, 8.3321608736e-3f);
  ps = fmaf(ps, z, -1.6666654611e-1f);
  const float sr = fmaf(ps * z, r, r);
  float pc = fmaf(z, 2.443315711809948e-5f, -1.388731625493765e-3f);
  pc = fmaf(pc, z, 4.166664568298827e-2f);
  const float cr = fmaf(pc * z, z, fmaf(-0.5f, z, 1.0f));
  // NaN and Inf angles give a NaN r, so any quadrant serves them
  const unsigned qi = static_cast<unsigned>(__float_as_int(t));
  const float ss = (qi & 1u) ? cr : sr;
  const float cc = (qi & 1u) ? sr : cr;
  *s = (qi & 2u) ? -ss : ss;
  *c = ((qi + 1u) & 2u) ? -cc : cc;
}
