// Helpers shared by the port's hand-written Hopper kernels.
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

// dtype codes shared with the Python wrappers
enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
