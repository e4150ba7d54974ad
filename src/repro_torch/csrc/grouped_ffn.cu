// grouped_ffn_blocked — per-block-expert SwiGLU over sorted, padded tokens.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_ffn/ffn.py
// (grouped_ffn_blocked): for every block of `block_tokens` rows with expert
// e = block_expert[block],
//     y = (silu(x Wg[e]) * (x Wu[e])) Wd[e]
// with the products and sums in float32, and y cast to x's dtype.  With
// `block_rows` (the number of token rows in each block, the rest padding),
// rows at or past a block's count are 0 and a 64-row tile that holds no
// token row is not computed.
//
// Bound on the H100: operations.  6 * rows * D * F FLOPs against reading each
// used expert's three [D, F] matrices once; at the slice's prefill (3731
// token rows, D 4096, F 16384) that is 1.50 TFLOP against 3.2 GB, above the
// machine balance.
//
// The TPU kernel carries the [bt, D] output sum across its sequential F grid
// axis.  Hopper's blocks run in no order, so the carry becomes two passes that
// each reduce inside one block:
//   pass 1  H[M, F] = silu(X Wg[e]) * (X Wu[e])
//   pass 2  Y[M, D] = H Wd[e]
// A 64-row tile never straddles two expert blocks (block_tokens is a multiple
// of 64), so each tile reads its expert id once.  Two routes:
//
// bfloat16, the serving path: tensor cores (grouped_ffn_blocked_tc).  One
// producer warp keeps a ring of stages filled by TMA (128-byte swizzle; X and
// H K-major, the [K, N] weights MN-major, read with wgmma's B-transpose bit),
// and two consumer warpgroups issue wgmma m64n256k16 with f32 accumulators,
// one warpgroup per 64-row tile of a pair of adjacent tiles of one expert:
// the pair shares each weight stage, which halves the weight traffic through
// L2 (with one tile a block, that traffic bounded the kernel).  Pass 1 reads
// Wg's and Wu's column slices as one 256-wide B, so gate and up share one
// accumulator and SwiGLU is an element-wise epilogue in registers; H is
// rounded to bf16 and stored (a bf16 [M, F] scratch, only the computed
// tiles' rows written).  Only tiles that hold a token are paired and
// computed (pass 2 writes the others' zeros).  Each pass is one persistent
// launch, a block per SM: the block builds the pair list itself (no host
// work beyond encoding the tensor maps), walks its share of the (pair,
// column slice) items with the pairs innermost, so that the pairs that need
// one N-slice of an expert's weights run together and share it through L2
// (each weight is read from HBM about once, not once per pair), and keeps
// its ring of stages running from one item into the next.
//
// float32: CUDA cores (grouped_ffn_blocked).  Shared-memory tiled GEMMs
// (64 x 64 and 64 x 128 tiles, 4 x 4 and 4 x 8 outputs a thread) through an
// f32 [M, F] scratch.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;   // rows per tile (divides block_tokens)

// token rows of the tile at row0 (its block's count less the tile's offset
// in the block, at most BM); BM without block_rows
__device__ __forceinline__ int live_rows(const int* block_rows, int row0, int block_tokens) {
  if (block_rows == nullptr) return BM;
  return min(BM, block_rows[row0 / block_tokens] - row0 % block_tokens);
}

// ============================ float32: CUDA cores ============================

constexpr int BK = 16;   // reduction depth per stage

// ---- pass 1: H = silu(X Wg) * (X Wu), tile 64 x 64, 256 threads, 4x4 each ----
constexpr int BN1 = 64;

__global__ void __launch_bounds__(256)
ffn_gate_up(const float* __restrict__ x, const int* __restrict__ block_expert,
            const int* __restrict__ block_rows, const float* __restrict__ wg,
            const float* __restrict__ wu, float* __restrict__ h, int D, int F,
            int block_tokens) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float gs[BK][BN1];
  __shared__ float us[BK][BN1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN1;
  if (live_rows(block_rows, (int)row0, block_tokens) <= 0) return;  // no token row
  const int e = block_expert[row0 / block_tokens];
  const float* wge = wg + (long long)e * D * F;
  const float* wue = wu + (long long)e * D * F;

  float ag[4][4] = {}, au[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = tid + 256 * q;
      const int m = l / BK, k = l % BK;           // x tile, stored transposed
      xs[k][m] = x[(row0 + m) * D + k0 + k];
      const int kk = l / BN1, n = l % BN1;         // weight tiles
      const long long w = (long long)(k0 + kk) * F + col0 + n;
      gs[kk][n] = wge[w];
      us[kk][n] = wue[w];
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

__global__ void __launch_bounds__(256)
ffn_down(const float* __restrict__ h, const int* __restrict__ block_expert,
         const int* __restrict__ block_rows, const float* __restrict__ wd,
         float* __restrict__ y, int D, int F, int block_tokens) {
  __shared__ float hs[BK][BM + 4];
  __shared__ float ws[BK][BN2];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN2;
  const int live = live_rows(block_rows, (int)row0, block_tokens);
  if (live <= 0) {  // no token row: zeros, nothing computed
    for (int l = tid; l < BM * BN2; l += 256)
      y[(row0 + l / BN2) * D + col0 + l % BN2] = 0.f;
    return;
  }
  const int e = block_expert[row0 / block_tokens];
  const float* wde = wd + (long long)e * F * D;

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
      ws[kk][n] = wde[(long long)(k0 + kk) * D + col0 + n];
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
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[(row0 + r) * D + col0 + tx + 16 * j] = r < live ? acc[i][j] : 0.f;
  }
}

// ========================== bfloat16: tensor cores ===========================

namespace tc {

constexpr int BKT = 64;                   // reduction depth per stage (one box)
constexpr int kThreads = 2 * 128 + 32;    // warpgroups 0, 1 consume (wgmma), warp 8 loads
constexpr int kBox = 64 * 64 * 2;         // one TMA box, 64 rows x 128 bytes: 8 KiB
constexpr int kABytes = 2 * kBox;         // A stage: [128 rows][64 k], a pair of row tiles

// B stage: [64 k][256 n] as four boxes, 8 KiB apart, read by one m64n256k16
// a k step.  Pass 1 puts Wg's and Wu's 128-column slices side by side there,
// so one accumulator holds gate (columns 0-127) and up (128-255) for 128
// output columns; pass 2 puts 256 columns of Wd, which halves its reads of H
// per FLOP.
constexpr int kBBytes = 4 * kBox;
constexpr int kMaxTiles = 4096;           // 64-row tiles a call: M <= 262144

template <bool GLU>
struct Cfg {
  static constexpr int kBN = GLU ? 128 : 256;        // output columns per item
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = kABytes + kBBytes;  // 48 KiB
  // stages, 1 KiB of slack to align them to the swizzle atom, the barriers,
  // the pair list
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8 + 4 * kMaxTiles;
};

// GLU (pass 1): out = bf16(silu(A B0) * (A B1)); else (pass 2): out = bf16(A B0)
// with rows at or past a tile's token count written as 0.  A [M, K] and the
// weights [E * K, N] come through the tensor maps; out is [M, N] row-major.
//
// Persistent: one block per SM.  The 64-row tiles that hold a token are
// paired along each run of adjacent such tiles of one expert, from the run's
// first tile (plain version: ops.py::_tile_pairs); each block builds that
// list in shared memory, then walks the items (pair, kBN-column slice), the
// pairs innermost so that the pairs that need one slice of weights run at
// once and share it through L2.  The two consumer warpgroups, one per tile
// of a pair, share every weight stage, so the weights cross L2 once per
// pair.  The ring runs on across items: the next item's loads overlap this
// one's epilogue.  Pass 2 first writes the zeros of the tiles that hold no
// token.
template <bool GLU>
__global__ void __launch_bounds__(kThreads, 1)
ffn_tc(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b0,
       const __grid_constant__ CUtensorMap map_b1, const int* __restrict__ block_expert,
       const int* __restrict__ block_rows, __nv_bfloat16* __restrict__ out, int K, int N,
       int n_tiles, int block_tokens) {
  using C = Cfg<GLU>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + C::kStages * C::kStageBytes;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * C::kStages;              // empty[s] = empty + 8 s
  // the pair list: first tiles of the pairs, after the barriers
  int* pairs = reinterpret_cast<int*>(smem_raw + (empty + 8 * C::kStages - smem_u32(smem_raw)));
  __shared__ int n_pairs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto tile_live = [&](int t) { return live_rows(block_rows, t * BM, block_tokens) > 0; };
  auto tile_expert = [&](int t) { return block_expert[t * BM / block_tokens]; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's arrival, plus the TMA bytes
      mbar_init(empty + 8 * s, 8);    // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  if (warp == 0) {
    // 32 tiles a step: a tile continues the run of the tile before it when
    // both hold a token of one expert; it opens a pair when its distance from
    // its run's first tile is even
    int n = 0, carry_first = 0, carry_e = -1, carry_live = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const int lv = t < n_tiles && tile_live(t);
      const int ex = t < n_tiles ? tile_expert(t) : -1;
      int prev_e = __shfl_up_sync(0xffffffffu, ex, 1);
      int prev_lv = __shfl_up_sync(0xffffffffu, lv, 1);
      if (lane == 0) prev_e = carry_e, prev_lv = carry_live;
      const bool opens_run = lv && !(prev_lv && prev_e == ex);
      const unsigned upto = __ballot_sync(0xffffffffu, opens_run) & (0xffffffffu >> (31 - lane));
      const int first = upto ? t0 + 31 - __clz(upto) : carry_first;
      const bool opens_pair = lv && ((t - first) & 1) == 0;
      const unsigned opens = __ballot_sync(0xffffffffu, opens_pair);
      if (opens_pair) pairs[n + __popc(opens & ((1u << lane) - 1))] = t;
      n += __popc(opens);
      carry_first = __shfl_sync(0xffffffffu, first, 31);
      carry_e = __shfl_sync(0xffffffffu, ex, 31);
      carry_live = __shfl_sync(0xffffffffu, lv, 31);
    }
    if (lane == 0) n_pairs = n;
  }
  if (!GLU) {
    // tiles that hold no token: zeros, nothing computed
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      if (tile_live(t)) continue;
      for (int i = threadIdx.x; i < BM * N / 8; i += kThreads)
        *reinterpret_cast<uint4*>(out + (size_t)t * BM * N + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  const int n_slices = (N + BN - 1) / BN;
  const int n_items = n_pairs * n_slices;
  const int n_k = K / BKT;
  if (warp == 8) {
    // ---- producer: one thread keeps the ring filled, item after item ----
    if (lane == 0) {
      int it = 0;                                  // stages used so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int t0 = pairs[item % n_pairs], n0 = item / n_pairs * BN;
        const int e = tile_expert(t0);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % C::kStages;
          mbar_wait(empty + 8 * s, ((it / C::kStages) & 1) ^ 1);  // first round: free
          const uint32_t st = base + s * C::kStageBytes;
          const uint32_t bar = full + 8 * s;
          mbar_arrive_expect_tx(bar, C::kStageBytes);
          tma_load_2d(st, &map_a, bar, kt * BKT, t0 * BM);      // 128 rows, both tiles
          const int krow = e * K + kt * BKT;                     // expert e's rows
#pragma unroll
          for (int hb = 0; hb < 4; ++hb) {                       // Wg | Wu, or Wd
            const int nb = GLU ? n0 + 64 * (hb % 2) : n0 + 64 * hb;
            tma_load_2d(st + kABytes + hb * kBox, GLU && hb >= 2 ? &map_b1 : &map_b0, bar, nb,
                        krow);
          }
        }
      }
    }
    return;
  }
  // ---- consumer warpgroup wg: rows of tile t0 + wg of each item ----
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;       // rows r and r + 8 of the tile
  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t0 = pairs[item % n_pairs], n0 = item / n_pairs * BN;
    // the second warpgroup works when the next tile continues t0's run
    const bool active = wg == 0 || (t0 + 1 < n_tiles && tile_live(t0 + 1) &&
                                    tile_expert(t0 + 1) == tile_expert(t0));
    if (!active) {                                 // release each stage as it comes
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % C::kStages;
        mbar_wait(full + 8 * s, (it / C::kStages) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      continue;
    }
    const int row0 = (t0 + wg) * BM;
    float acc[128];                                // 64 x 256, see kBBytes
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % C::kStages;
      mbar_wait(full + 8 * s, (it / C::kStages) & 1);
      const uint32_t st = base + s * C::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_m64n256k16_ss<1>(acc, desc_kmajor(st + wg * kBox, kk, kBox),
                               desc_mnmajor(st + kABytes, kk, kBox), 1);
      wgmma_commit();
      wgmma_wait<1>();                  // the previous stage's products are done
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % C::kStages));
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % C::kStages));  // the item's last

    // ---- epilogue: rows r and r + 8 of each 8-column group, on a quad ----
    const int live = live_rows(block_rows, row0, block_tokens);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r + 8 * hr;
        float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
        if constexpr (GLU) {                     // up: 128 columns (16 groups) on
          v0 = v0 / (1.0f + __expf(-v0)) * acc[4 * (j + 16) + 2 * hr];
          v1 = v1 / (1.0f + __expf(-v1)) * acc[4 * (j + 16) + 2 * hr + 1];
        } else if (row >= live) {
          v0 = v1 = 0.f;
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + row) * N + col) = pack_bf16(v0, v1);
      }
    }
  }
}

template <bool GLU>
int launch_pass(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1,
                const int* be, const int* rows, __nv_bfloat16* out, int M, int K, int N, int bt,
                cudaStream_t s) {
  int dev = 0, n_sm = 0;                  // one block per SM
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaFuncSetAttribute(ffn_tc<GLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Cfg<GLU>::kSmem);
  if (err) return err;
  ffn_tc<GLU><<<n_sm, kThreads, Cfg<GLU>::kSmem, s>>>(a, b0, b1, be, rows, out, K, N, M / BM,
                                                      bt);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 route.  x [M, D], block_expert [M / bt] int32, block_rows [M / bt]
// int32 or null, wg/wu [E, D, F], wd [E, F, D], h [M, F] scratch, y [M, D], all
// float32.  Requires M % 64 == 0, bt % 64 == 0, D % 128 == 0, F % 64 == 0.
extern "C" int grouped_ffn_blocked(const void* x, const void* block_expert,
                                   const void* block_rows, const void* wg, const void* wu,
                                   const void* wd, void* h, void* y, int M, int D, int F,
                                   int block_tokens, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  const int* rows = static_cast<const int*>(block_rows);
  ffn_gate_up<<<dim3(F / BN1, M / BM), 256, 0, s>>>(
      static_cast<const float*>(x), be, rows, static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<float*>(h), D, F, block_tokens);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ffn_down<<<dim3(D / BN2, M / BM), 256, 0, s>>>(
      static_cast<const float*>(h), be, rows, static_cast<const float*>(wd),
      static_cast<float*>(y), D, F, block_tokens);
  return (int)cudaGetLastError();
}

// bfloat16 route on tensor cores.  The same arguments, all bfloat16, with the
// experts' count E and h a bf16 [M, F] scratch.  Requires M % 64 == 0,
// bt % 64 == 0, D % 128 == 0, F % 64 == 0 and 16-byte aligned pointers.
extern "C" int grouped_ffn_blocked_tc(const void* x, const void* block_expert,
                                      const void* block_rows, const void* wg, const void* wu,
                                      const void* wd, void* h, void* y, int M, int D, int F,
                                      int E, int block_tokens, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  const int* rows = static_cast<const int*>(block_rows);
  CUtensorMap mx, mwg, mwu, mh, mwd;
  const uint64_t dx[2] = {(uint64_t)D, (uint64_t)M}, dw[2] = {(uint64_t)F, (uint64_t)E * D};
  const uint64_t dh[2] = {(uint64_t)F, (uint64_t)M}, dd[2] = {(uint64_t)D, (uint64_t)E * F};
  int err = encode_bf16_map(&mx, x, 2, dx, 2 * BM);
  if (!err) err = encode_bf16_map(&mwg, wg, 2, dw, 64);
  if (!err) err = encode_bf16_map(&mwu, wu, 2, dw, 64);
  if (!err) err = encode_bf16_map(&mh, h, 2, dh, 2 * BM);
  if (!err) err = encode_bf16_map(&mwd, wd, 2, dd, 64);
  if (err) return err;
  auto* hp = static_cast<__nv_bfloat16*>(h);
  err = tc::launch_pass<true>(mx, mwg, mwu, be, rows, hp, M, D, F, block_tokens, s);
  if (err) return err;
  return tc::launch_pass<false>(mh, mwd, mwd, be, rows, static_cast<__nv_bfloat16*>(y), M, F,
                                D, block_tokens, s);
}
