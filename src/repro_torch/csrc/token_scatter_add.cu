// token_scatter_add — gx[n] = sum of g[i] over the i with idx[i] = n, a zero
// row where no i points at n; the backward of token_gather.
//
// Replaces no Pallas kernel: the JAX package's token_gather takes its
// gradient from an XLA scatter-add (repro/kernels/token_scatter/ops.py:30,
// `_bwd`, `.at[safe].add`).  On the port's training path it carries the
// gradient back through the dispatch's pack (each token read up to top_k
// times), the dataplane's slot fill, relay rounds and reassembly, and the
// combine's gather (each an injective gather: at most one source a row).
//
// Bound on the H100: bytes.  It reads the rows whose index is >= 0, writes
// N rows of D * itemsize bytes and reads the M indices (and the inverse
// index the wrapper builds); it adds at most top_k terms an element, so the
// least time is (reads + writes) / 3.35 TB/s.
//
// Design: no atomics, so the result does not depend on the order in which
// blocks run and a second run gives the same bits (the paper's determinism,
// §I; `index_add_` on CUDA gives neither that nor speed for bfloat16).  The
// wrapper (kernels/token_scatter/ops.py, `inverse_index`) builds the
// inverse index with device ops that read nothing back to the host: a
// stable sort of the clipped 32-bit row ids (`order`; negative ids sort
// last) and each output row's first entry in it by a binary search
// (`offsets`, `searchsorted`).  Each output row is then
// a gather of its sources in increasing i, summed in float32 and written
// once in g's type: a row with one source is copied exactly, and a row with
// two sources rounds once, so it equals either order of the two terms bit
// for bit.  The launch geometry is token_gather's (`geometry()` in ops.py):
// units of a power-of-two thread group on a (row groups) x (segments of
// 16 KiB) grid, so a wide row still fills the card; a thread holds kUnroll
// words of each source in flight.  Words are 16 bytes where the row width
// and both base addresses allow it, else 4 or 2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // words a thread sums at once (ops.py: UNROLL)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V: the word a thread loads (uint4, uint32_t or uint16_t); T: the element
// type (float or __nv_bfloat16).
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows(const V* __restrict__ g, const long long* __restrict__ order,
                 const long long* __restrict__ offsets, V* __restrict__ out,
                 long long n_rows, long long row_words, long long seg_words, int group) {
  constexpr int kElems = sizeof(V) / sizeof(T);
  const int unit = threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * (kThreads / group) + unit;
  if (row >= n_rows) return;
  const long long w0 = (long long)blockIdx.y * seg_words;
  const long long w1 = min(w0 + seg_words, row_words);
  const long long first = offsets[row], last = offsets[row + 1];
  V* o = out + row * row_words;
  const long long stride = (long long)group * kUnroll;
  for (long long j = w0 + lane; j < w1; j += stride) {
    float acc[kUnroll][kElems];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[u][e] = 0.f;
    for (long long c = first; c < last; ++c) {
      const V* s = g + order[c] * row_words;
      V r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long w = j + (long long)u * group;
        if (w < w1) r[u] = __ldg(s + w);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long w = j + (long long)u * group;
        if (w < w1) {
          const T* el = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[u][e] += to_f32(el[e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = j + (long long)u * group;
      if (w < w1) {
        V packed;
        T* el = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int e = 0; e < kElems; ++e) el[e] = from_f32<T>(acc[u][e]);
        o[w] = packed;
      }
    }
  }
}

template <typename T>
int launch(const void* g, const long long* order, const long long* offsets, void* out,
           long long n, long long row_bytes, int word, long long seg_words, int group,
           dim3 grid, cudaStream_t s) {
  const long long rw = row_bytes / word;
  if (word == 16)
    scatter_add_rows<uint4, T><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(g), order, offsets, static_cast<uint4*>(out), n, rw,
        seg_words, group);
  else if (word == 4)
    scatter_add_rows<uint32_t, T><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(g), order, offsets, static_cast<uint32_t*>(out), n, rw,
        seg_words, group);
  else if (sizeof(T) == 2)
    scatter_add_rows<uint16_t, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(g), order, offsets, static_cast<uint16_t*>(out), n, rw,
        seg_words, group);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// g: [m, row_bytes] of float32 (is_bf16 0) or bfloat16 (1); order: [m]
// int64, the rows of g sorted by their output row (stable); offsets: [n + 1]
// int64, output row r sums g[order[offsets[r]]] .. g[order[offsets[r+1]-1]],
// every entry in [0, m); out: [n, row_bytes].  The geometry is
// token_gather's: words of word_bytes (16, 4 or 2, dividing row_bytes and
// both base addresses; 2 only for bfloat16), segments of seg_words words,
// `group` threads a unit (a power of two up to 256), and a grid of grid_x
// blocks of 256 / group output rows by grid_y segments, which must cover
// every row and every word.
extern "C" int token_scatter_add(const void* g, const void* order, const void* offsets,
                                 void* out, long long n, long long row_bytes, int is_bf16,
                                 int word_bytes, long long seg_words, int group,
                                 long long grid_x, long long grid_y, void* stream) {
  const uintptr_t align = (uintptr_t)g | (uintptr_t)out;
  const int elem = is_bf16 ? 2 : 4;
  const bool word_ok = (word_bytes == 16 || word_bytes == 4 || word_bytes == 2) &&
                       word_bytes >= elem && row_bytes % word_bytes == 0 &&
                       align % word_bytes == 0;
  const bool unit_ok =
      group >= 1 && group <= kThreads && (group & (group - 1)) == 0 && seg_words >= 1;
  if (!word_ok || !unit_ok || n < 1) return (int)cudaErrorInvalidValue;
  const long long row_words = row_bytes / word_bytes;
  const long long rows_per_block = kThreads / group;
  if (grid_x < 1 || grid_x > 2147483647LL || grid_y < 1 || grid_y > 65535 ||
      grid_x * rows_per_block < n || grid_y * seg_words < row_words)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ord = static_cast<const long long*>(order);
  const long long* off = static_cast<const long long*>(offsets);
  if (is_bf16)
    return launch<__nv_bfloat16>(g, ord, off, out, n, row_bytes, word_bytes, seg_words,
                                 group, grid, s);
  return launch<float>(g, ord, off, out, n, row_bytes, word_bytes, seg_words, group, grid,
                       s);
}
