// Shared pieces of the package's CUDA kernels (plain C interface, no
// PyTorch headers: the library is built by nvcc alone and loaded with
// ctypes, see relation_detr_tpu_torch/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every C entry returns a cudaError_t as int: cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() right after
// the launch (a refused launch never runs, and a later synchronize does not
// report it).
#define RDETR_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
#define RDETR_INVALID static_cast<int>(cudaErrorInvalidValue)
