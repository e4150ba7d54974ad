// grouped_ffn_blocked — per-block-expert SwiGLU over sorted, padded tokens.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_ffn/ffn.py
// (grouped_ffn_blocked): for every block of `block_tokens` rows with expert
// e = block_expert[block],
//     y = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
// with the products and sums in float32 on float32 or bfloat16 inputs, and y
// cast to x's dtype.
//
// Bound on the H100: operations.  6 * rows * D * F multiply-adds' worth of
// FLOPs against reading each used expert's three [D, F] matrices once; at the
// slice's prefill (8704 padded rows, D 4096, F 16384) that is 3.5 TFLOP, far
// above the machine balance.
//
// Design.  The TPU kernel carries the [bt, D] output sum across its sequential
// F grid axis.  Hopper's blocks run in no order, so the carry becomes two
// passes that each reduce inside one block:
//   pass 1  H[M, F] = silu(X Wg[e]) * (X Wu[e])   (float32 scratch from the wrapper)
//   pass 2  Y[M, D] = H Wd[e]
// Each pass is a shared-memory tiled GEMM on the CUDA cores in float32: a
// 64-row tile never straddles two expert blocks (block_tokens is a multiple of
// 64), so each block loads its expert id once from block_expert.  Inputs are
// widened to float32 as they are staged in shared memory.  Every row of M is
// computed, the zero blocks past the last segment included (they give zeros).
// This is the simple, correct first version: no tensor cores, no TMA, no
// pipelining.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // rows per tile (divides block_tokens)
constexpr int BK = 16;   // reduction depth per stage

// ---- pass 1: H = silu(X Wg) * (X Wu), tile 64 x 64, 256 threads, 4x4 each ----
constexpr int BN1 = 64;

template <typename T>
__global__ void __launch_bounds__(256)
ffn_gate_up(const T* __restrict__ x, const int* __restrict__ block_expert,
            const T* __restrict__ wg, const T* __restrict__ wu, float* __restrict__ h,
            int D, int F, int block_tokens) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float gs[BK][BN1];
  __shared__ float us[BK][BN1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN1;
  const int e = block_expert[row0 / block_tokens];
  const T* wge = wg + (long long)e * D * F;
  const T* wue = wu + (long long)e * D * F;

  float ag[4][4] = {}, au[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = tid + 256 * q;
      const int m = l / BK, k = l % BK;           // x tile, stored transposed
      xs[k][m] = to_f32(x[(row0 + m) * D + k0 + k]);
      const int kk = l / BN1, n = l % BN1;         // weight tiles
      const long long w = (long long)(k0 + kk) * F + col0 + n;
      gs[kk][n] = to_f32(wge[w]);
      us[kk][n] = to_f32(wue[w]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bg[4], bu[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) { bg[j] = gs[k][tx + 16 * j]; bu[j] = us[k][tx + 16 * j]; }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ag[i][j] = fmaf(a[i], bg[j], ag[i][j]);
          au[i][j] = fmaf(a[i], bu[j], au[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = ag[i][j];
      const float silu = g / (1.0f + expf(-g));
      h[(row0 + ty + 16 * i) * F + col0 + tx + 16 * j] = silu * au[i][j];
    }
}

// ---- pass 2: Y = H Wd, tile 64 x 128, 256 threads, 4x8 each ----
constexpr int BN2 = 128;

template <typename T>
__global__ void __launch_bounds__(256)
ffn_down(const float* __restrict__ h, const int* __restrict__ block_expert,
         const T* __restrict__ wd, T* __restrict__ y, int D, int F, int block_tokens) {
  __shared__ float hs[BK][BM + 4];
  __shared__ float ws[BK][BN2];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN2;
  const int e = block_expert[row0 / block_tokens];
  const T* wde = wd + (long long)e * F * D;

  float acc[4][8] = {};
  for (int k0 = 0; k0 < F; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = tid + 256 * q;
      const int m = l / BK, k = l % BK;
      hs[k][m] = h[(row0 + m) * F + k0 + k];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int l = tid + 256 * q;
      const int kk = l / BN2, n = l % BN2;
      ws[kk][n] = to_f32(wde[(long long)(k0 + kk) * D + col0 + n]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[(row0 + ty + 16 * i) * D + col0 + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

template <typename T>
int launch(const void* x, const void* be, const void* wg, const void* wu, const void* wd,
           void* h, void* y, int M, int D, int F, int bt, cudaStream_t s) {
  const dim3 threads(256);
  ffn_gate_up<T><<<dim3(F / BN1, M / BM), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(be), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<float*>(h), D, F, bt);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ffn_down<T><<<dim3(D / BN2, M / BM), threads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const int*>(be), static_cast<const T*>(wd),
      static_cast<T*>(y), D, F, bt);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D], block_expert [M / bt] int32, wg/wu [E, D, F], wd [E, F, D] (all
// dtype `dtype`), h [M, F] float32 scratch, y [M, D] dtype.
// Requires M % 64 == 0, bt % 64 == 0, D % 128 == 0, F % 64 == 0.
extern "C" int grouped_ffn_blocked(const void* x, const void* block_expert, const void* wg,
                                   const void* wu, const void* wd, void* h, void* y, int M,
                                   int D, int F, int block_tokens, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, block_expert, wg, wu, wd, h, y, M, D, F, block_tokens, s);
  return launch<float>(x, block_expert, wg, wu, wd, h, y, M, D, F, block_tokens, s);
}
