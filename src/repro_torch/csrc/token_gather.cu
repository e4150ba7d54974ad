// token_gather — out[i] = x[idx[i]], a zero row where idx[i] < 0.
//
// Replaces the Pallas TPU kernel repro/kernels/token_scatter/scatter.py
// (token_gather), the "Kernel Scatter" pack stage of the paper (§IV-A).  In
// the port it also carries the dataplane's slot fill, each relay round's hop
// permutation along the stacked rank axis, the reassembly, the combine
// gather, and the grouped FFN's sort/pad and unsort.
//
// Bound on the H100: bytes.  It reads M rows and writes M rows of
// D * itemsize bytes (plus M indices) and does no arithmetic, so the least
// time is 2 * M * D * itemsize / 3.35 TB/s.
//
// Design: the kernel moves raw bytes, so one kernel serves float32 (the
// payload and the expert-id sideband) and bfloat16.  One warp copies one
// row; lanes stride over the row in 16-byte vectors when the row width and
// both base pointers allow it (4- or 2-byte words otherwise), so a warp
// issues 512-byte coalesced transactions.  A negative index writes zeros, so
// no row is read for it; an index past the last row reads the last row, as
// the reference's clip does.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V, typename I>
__global__ void gather_rows(const V* __restrict__ x, const I* __restrict__ idx,
                            V* __restrict__ out, long long n_rows, long long m_rows,
                            long long row_words) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= m_rows) return;
  const int lane = threadIdx.x % 32;
  V* o = out + row * row_words;
  long long src = (long long)idx[row];
  if (src < 0) {
    V zero{};
    for (long long j = lane; j < row_words; j += 32) o[j] = zero;
    return;
  }
  if (src >= n_rows) src = n_rows - 1;
  const V* s = x + src * row_words;
  for (long long j = lane; j < row_words; j += 32) o[j] = s[j];
}

template <typename I>
int launch(const void* x, const void* idx, void* out, long long n, long long m,
           long long row_bytes, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 threads(32 * kWarpsPerBlock);
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  const I* ix = static_cast<const I*>(idx);
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    gather_rows<uint4, I><<<blocks, threads, 0, stream>>>(
        static_cast<const uint4*>(x), ix, static_cast<uint4*>(out), n, m, row_bytes / 16);
  } else if (row_bytes % 4 == 0 && align % 4 == 0) {
    gather_rows<uint32_t, I><<<blocks, threads, 0, stream>>>(
        static_cast<const uint32_t*>(x), ix, static_cast<uint32_t*>(out), n, m, row_bytes / 4);
  } else {
    gather_rows<uint16_t, I><<<blocks, threads, 0, stream>>>(
        static_cast<const uint16_t*>(x), ix, static_cast<uint16_t*>(out), n, m, row_bytes / 2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, row_bytes] bytes, idx: [m] int32 or int64 (idx_bytes 4 or 8),
// out: [m, row_bytes].  row_bytes must be even.
extern "C" int token_gather(const void* x, const void* idx, void* out, long long n,
                            long long m, long long row_bytes, int idx_bytes,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) return launch<long long>(x, idx, out, n, m, row_bytes, s);
  return launch<int>(x, idx, out, n, m, row_bytes, s);
}
