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
// N rows of D * itemsize bytes and reads the M indices; it adds at most
// top_k terms an element, so the least time is (reads + writes) / 3.35 TB/s.
//
// Design: no atomics on data, so the result does not depend on the order in
// which blocks run and a second run gives the same bits (the paper's
// determinism, §I; `index_add_` on CUDA gives neither that nor speed for
// bfloat16).  Two launches, both on the stream the caller gives:
//
//  1. `inverse_index` builds (order, offsets): output row r sums the rows
//     order[offsets[r]] .. order[offsets[r+1]-1] of g, in increasing i; the
//     entries with idx < 0 come last, in increasing i.  It is a counting
//     sort of the clipped row ids (key n for idx < 0), equal bit for bit to
//     a stable sort plus a binary search (ops.py, `inverse_index`, the plain
//     version), in one launch that reads nothing back to the host.  A block
//     owns kKeys = 512 consecutive keys and keeps their counters in shared
//     memory, and each block reads all M indices: the train path's calls
//     have n + 1 <= 8193 keys and M <= 8192 indices (at most 17 blocks).  A
//     block's fixed cost (its counters, two block-wide scans, two dependent
//     walks) sets the launch's time at these sizes, so smaller blocks in
//     parallel beat one large one; a call of many more rows and indices
//     would want a pass that splits the indices too.  Each of
//     a block's 32 warps walks a contiguous range of the indices, 32 at a
//     time and in order; lanes with one key are found by __match_any_sync,
//     and the lowest of them adds their number to the warp's own counter of
//     that key (integer adds, no atomics: the counts are exact in any
//     order).  An exclusive scan over (key, warp) then gives each warp's
//     first place in each key's run, and a second walk places each entry at
//     that place plus its rank among its warp's earlier lanes of the key.
//     The warps' ranges are contiguous and walked in order, so each key's
//     entries land in increasing i: the sort is stable.  The entries with a
//     key below the block's range are counted too; their number is where
//     the block's first key starts.
//  2. `scatter_add_rows`: each output row is a gather of its sources in
//     increasing i.  A row with no source writes zeros, a row with one
//     copies its words unchanged (token_gather's inner loop), and only a
//     row with two or more sums them in float32, written once in g's type:
//     a row with two sources rounds once, so it equals either order of the
//     two terms bit for bit.  The launch geometry is token_gather's
//     (`geometry()` in ops.py): units of a power-of-two thread group on a
//     (row groups) x (segments of 16 KiB) grid, so a wide row still fills
//     the card; a thread holds kUnroll words of each source in flight.
//     Words are 16 bytes where the row width and both base addresses allow
//     it, else 4 or 2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // words a thread sums at once (ops.py: UNROLL)

constexpr int kIdxThreads = 1024;                 // inverse_index: 32 walking warps
constexpr int kWarps = kIdxThreads / 32;
constexpr int kKeys = 512;                        // keys a block counts (ops.py: INDEX_KEYS)
constexpr int kBatch = 4;                         // indices a lane loads at once
constexpr int kIdxSmem = (kWarps + 1) * kKeys * 4;  // counters + starts: 67,584 bytes
constexpr int kMaxDevices = 64;

template <typename I>
__device__ __forceinline__ int key_of(I v, int n) {
  const long long x = static_cast<long long>(v);
  return x < 0 ? n : static_cast<int>(x < n - 1 ? x : n - 1);
}

template <typename I>
__global__ void __launch_bounds__(kIdxThreads)
inverse_index(const I* __restrict__ idx, long long m, int n, long long* __restrict__ order,
              long long* __restrict__ offsets) {
  extern __shared__ __align__(16) unsigned smem[];
  const int k0 = blockIdx.x * kKeys;
  const int nk = min(kKeys, n + 1 - k0);           // this block's keys
  unsigned* count = smem;                          // [kWarps][nk]: a warp's entries a key
  unsigned* start = smem + kWarps * nk;            // [nk]
  __shared__ unsigned long long below_w[kWarps];
  __shared__ unsigned scan_w[kWarps];
  const unsigned kAll = 0xffffffffu;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < kWarps * nk; j += kIdxThreads) count[j] = 0;
  __syncthreads();

  // warp w walks the indices [lo, hi), whole steps of 32
  const long long per = ((m + 31) / 32 + kWarps - 1) / kWarps * 32;
  const long long lo = min(m, (long long)warp * per), hi = min(m, lo + per);
  unsigned* mine = count + warp * nk;
  auto load = [&](long long base, int (&key)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = base + u * 32 + lane;
      key[u] = i < hi ? key_of(idx[i], n) : -1;
    }
  };
  // the steps of this batch that hold an index (the same for every lane)
  auto steps = [&](long long base) { return (int)min((long long)kBatch, (hi - base + 31) / 32); };
  unsigned long long below = 0;
  for (long long base = lo; base < hi; base += 32 * kBatch) {
    int key[kBatch];
    load(base, key);
    const int used = steps(base);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u == used) break;
      below += key[u] >= 0 && key[u] < k0;
      const int kk = key[u] - k0;
      const bool in = key[u] >= k0 && kk < nk;
      const unsigned group = __match_any_sync(kAll, in ? kk : -1) & __ballot_sync(kAll, in);
      if (in && lane == __ffs(group) - 1) mine[kk] += __popc(group);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) below += __shfl_down_sync(kAll, below, o);
  if (lane == 0) below_w[warp] = below;
  // each key: the warps' exclusive prefix in place, its total in start
  __syncthreads();
  for (int j = threadIdx.x; j < nk; j += kIdxThreads) {
    unsigned run = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = count[w * nk + j];
      count[w * nk + j] = run;
      run += c;
    }
    start[j] = run;
  }
  unsigned long long before = 0;                   // entries with a key below k0
  for (int w = 0; w < kWarps; ++w) before += below_w[w];
  __syncthreads();

  // exclusive scan of the keys' totals: thread t owns keys [j0, j1)
  const int per_t = (nk + kIdxThreads - 1) / kIdxThreads;
  const int j0 = min(nk, (int)threadIdx.x * per_t), j1 = min(nk, j0 + per_t);
  unsigned local = 0;
  for (int j = j0; j < j1; ++j) local += start[j];
  unsigned incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan_w[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned mine_w = lane < kWarps ? scan_w[lane] : 0;
    unsigned w_incl = mine_w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kAll, w_incl, o);
      if (lane >= o) w_incl += v;
    }
    if (lane < kWarps) scan_w[lane] = w_incl - mine_w;
  }
  __syncthreads();
  unsigned run = static_cast<unsigned>(before) + scan_w[warp] + incl - local;
  for (int j = j0; j < j1; ++j) {
    const unsigned c = start[j];
    start[j] = run;
    offsets[k0 + j] = run;
    run += c;
  }
  __syncthreads();

  // place each entry: its key's start, the earlier warps' entries of the
  // key, this warp's earlier steps' and its lower lanes' of this step
  for (long long base = lo; base < hi; base += 32 * kBatch) {
    int key[kBatch];
    load(base, key);
    const int used = steps(base);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u == used) break;
      const int kk = key[u] - k0;
      const bool in = key[u] >= k0 && kk < nk;
      const unsigned group = __match_any_sync(kAll, in ? kk : -1) & __ballot_sync(kAll, in);
      const int leader = in ? __ffs(group) - 1 : lane;
      unsigned seen = 0;
      if (in && lane == leader) {
        seen = mine[kk];
        mine[kk] = seen + __popc(group);
      }
      seen = __shfl_sync(kAll, seen, leader);
      if (in)
        order[start[kk] + seen + __popc(group & ((1u << lane) - 1u))] = base + u * 32 + lane;
    }
  }
}

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
  if (last == first) {                     // no source: a zero row
    const V zero{};
    for (long long j = w0 + lane; j < w1; j += group) o[j] = zero;
    return;
  }
  if (last == first + 1) {                 // one source: its words, unchanged
    const V* s = g + order[first] * row_words;
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
    return;
  }
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
int launch_rows(const void* g, const long long* order, const long long* offsets, void* out,
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

// the dynamic shared-memory attribute, set once a device for each index type
template <typename I>
int index_ready() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = (int)cudaFuncSetAttribute(inverse_index<I>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kIdxSmem);
    if (err) return err;
    ready[dev] = true;
  }
  return 0;
}

template <typename I>
int launch_index(const void* idx, long long m, int n, long long* order, long long* offsets,
                 cudaStream_t s) {
  const int err = index_ready<I>();
  if (err) return err;
  const unsigned blocks = (unsigned)((n + 1 + kKeys - 1) / kKeys);
  inverse_index<I><<<blocks, kIdxThreads, kIdxSmem, s>>>(static_cast<const I*>(idx), m, n,
                                                         order, offsets);
  return (int)cudaGetLastError();
}

int index_call(const void* idx, long long m, long long n, int idx_bytes, void* order,
               void* offsets, cudaStream_t s) {
  if (n < 1 || n >= 2147483647LL || m < 0 || m >= 2147483647LL ||
      (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  long long* ord = static_cast<long long*>(order);
  long long* off = static_cast<long long*>(offsets);
  if (idx_bytes == 8) return launch_index<long long>(idx, m, (int)n, ord, off, s);
  return launch_index<int>(idx, m, (int)n, ord, off, s);
}

}  // namespace

// idx: [m] int32 (idx_bytes 4) or int64 (8); order: [m] int64; offsets:
// [n + 1] int64.  Output row r of the scatter-add sums g[order[offsets[r]]]
// .. g[order[offsets[r+1]-1]], in increasing i; order[offsets[n]:] lists
// the i with idx[i] < 0.  One launch of ceil((n + 1) / 512) blocks.
extern "C" int token_scatter_index(const void* idx, long long m, long long n, int idx_bytes,
                                   void* order, void* offsets, void* stream) {
  return index_call(idx, m, n, idx_bytes, order, offsets, static_cast<cudaStream_t>(stream));
}

// g: [m, row_bytes] of float32 (is_bf16 0) or bfloat16 (1); idx: [m] as
// above; order [m] and offsets [n + 1] int64: scratch that the first launch
// fills (token_scatter_index) and the second reads; out: [n, row_bytes].
// The geometry is token_gather's: words of word_bytes (16, 4 or 2, dividing
// row_bytes and both base addresses; 2 only for bfloat16), segments of
// seg_words words, `group` threads a unit (a power of two up to 256), and a
// grid of grid_x blocks of 256 / group output rows by grid_y segments, which
// must cover every row and every word.
extern "C" int token_scatter_add(const void* g, const void* idx, int idx_bytes, long long m,
                                 void* order, void* offsets, void* out, long long n,
                                 long long row_bytes, int is_bf16, int word_bytes,
                                 long long seg_words, int group, long long grid_x,
                                 long long grid_y, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = index_call(idx, m, n, idx_bytes, order, offsets, s);
  if (err) return err;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const long long* ord = static_cast<const long long*>(order);
  const long long* off = static_cast<const long long*>(offsets);
  if (is_bf16)
    return launch_rows<__nv_bfloat16>(g, ord, off, out, n, row_bytes, word_bytes, seg_words,
                                      group, grid, s);
  return launch_rows<float>(g, ord, off, out, n, row_bytes, word_bytes, seg_words, group,
                            grid, s);
}
