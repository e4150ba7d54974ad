// Includes and conventions shared by the port's hand-written Hopper kernels.
//
// Each kernel file is compiled on its own into a shared library with a plain
// C interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared), loaded by
// repro_torch.kernels._build with ctypes.  Every entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
