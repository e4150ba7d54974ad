// token_gather — out[i] = x[idx[i]], a zero row where idx[i] < 0.
//
// Replaces the Pallas TPU kernel repro/kernels/token_scatter/scatter.py
// (token_gather), the "Kernel Scatter" pack stage of the paper (§IV-A).  In
// the port it also carries the dataplane's slot fill, each relay round's hop
// permutation along the stacked rank axis, the reassembly, the combine
// gather, and the grouped FFN's sort/pad and unsort.
//
// Bound on the H100: bytes.  It reads the rows whose index is >= 0 and
// writes M rows of D * itemsize bytes (plus M indices) and does no
// arithmetic, so the least time is (reads + writes) / 3.35 TB/s.
//
// Design: the kernel moves raw bytes, so one kernel serves float32 (the
// payload and the expert-id sideband) and bfloat16.  The unit of work is a
// segment of a row, not a whole row: the grid is (groups of rows) x
// (segments a row), so a 128 KiB payload row is cut into several segments
// and a call of a few hundred rows still puts blocks on every SM.  A unit is
// a power-of-two group of threads; rows narrower than a segment pack
// 256 / group units into a block (a few lanes a row for the 64-byte sideband
// rows).  Each thread issues kUnroll = 4 independent 16-byte loads before
// its stores, so an SM holds enough bytes in flight to keep HBM busy.  Words are
// 16 bytes when the row width and both base pointers allow it, 4 or 2 bytes
// otherwise (offset views).  A negative index writes zeros and reads
// nothing; an index past the last row reads the last row, as the
// reference's clip does.  The wrapper (kernels/token_scatter/ops.py,
// `geometry`) chooses word, segment and group; this file checks them.  The
// segment (16 KiB) and kUnroll were chosen on the card: segments of 4 to
// 64 KiB and unrolls of 1 to 8 timed within 1.5% of each other.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // loads in flight a thread (ops.py: UNROLL)

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows(const V* __restrict__ x, const I* __restrict__ idx, V* __restrict__ out,
            long long n_rows, long long m_rows, long long row_words, long long seg_words,
            int group) {
  const int unit = threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * (kThreads / group) + unit;
  if (row >= m_rows) return;
  const long long w0 = (long long)blockIdx.y * seg_words;
  const long long w1 = min(w0 + seg_words, row_words);
  V* o = out + row * row_words;
  long long src = (long long)idx[row];
  if (src < 0) {
    const V zero{};
    for (long long j = w0 + lane; j < w1; j += group) o[j] = zero;
    return;
  }
  if (src >= n_rows) src = n_rows - 1;
  const V* s = x + src * row_words;
  const long long stride = (long long)group * kUnroll;
  for (long long j = w0 + lane; j < w1; j += stride) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = j + (long long)u * group;
      if (w < w1) r[u] = __ldg(s + w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = j + (long long)u * group;
      if (w < w1) o[w] = r[u];
    }
  }
}

template <typename I>
int launch(const void* x, const void* idx, void* out, long long n, long long m,
           long long row_bytes, int word, long long seg_words, int group, dim3 grid,
           cudaStream_t s) {
  const I* ix = static_cast<const I*>(idx);
  const long long rw = row_bytes / word;
  if (word == 16)
    gather_rows<uint4, I><<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(x), ix,
                                                    static_cast<uint4*>(out), n, m, rw,
                                                    seg_words, group);
  else if (word == 4)
    gather_rows<uint32_t, I><<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(x), ix,
                                                       static_cast<uint32_t*>(out), n, m, rw,
                                                       seg_words, group);
  else
    gather_rows<uint16_t, I><<<grid, kThreads, 0, s>>>(static_cast<const uint16_t*>(x), ix,
                                                       static_cast<uint16_t*>(out), n, m, rw,
                                                       seg_words, group);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, row_bytes] bytes, idx: [m] int32 or int64 (idx_bytes 4 or 8),
// out: [m, row_bytes].  The geometry: words of word_bytes (16, 4 or 2,
// dividing row_bytes and both base addresses), segments of seg_words words,
// `group` threads a unit (a power of two up to 256), and a grid of grid_x
// blocks of 256 / group rows by grid_y segments, which must cover every row
// and every word.
extern "C" int token_gather(const void* x, const void* idx, void* out, long long n,
                            long long m, long long row_bytes, int idx_bytes,
                            int word_bytes, long long seg_words, int group,
                            long long grid_x, long long grid_y, void* stream) {
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  const bool word_ok = (word_bytes == 16 || word_bytes == 4 || word_bytes == 2) &&
                       row_bytes % word_bytes == 0 && align % word_bytes == 0;
  const bool unit_ok =
      group >= 1 && group <= kThreads && (group & (group - 1)) == 0 && seg_words >= 1;
  if (!word_ok || !unit_ok || (idx_bytes != 4 && idx_bytes != 8) || n < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_words = row_bytes / word_bytes;
  const long long rows_per_block = kThreads / group;
  if (grid_x < 1 || grid_x > 2147483647LL || grid_y < 1 || grid_y > 65535 ||
      grid_x * rows_per_block < m || grid_y * seg_words < row_words)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8)
    return launch<long long>(x, idx, out, n, m, row_bytes, word_bytes, seg_words, group,
                             grid, s);
  return launch<int>(x, idx, out, n, m, row_bytes, word_bytes, seg_words, group, grid, s);
}
