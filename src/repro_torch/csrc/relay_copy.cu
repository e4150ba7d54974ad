// relay_copy — identity copy of [N, D] through two shared-memory staging slots.
//
// Replaces the Pallas TPU kernel repro/kernels/relay_copy/relay.py
// (relay_copy), the staging discipline of the paper's relay buffers (§IV-C):
// a large buffer moves chunk by chunk (block_chunk rows) through a small
// window of two slots, and the slot each chunk passes through is runtime
// data, slot_map[chunk], so a new schedule re-targets slots without a new
// kernel (the map is a device pointer the host never reads).
//
// Bound on the H100: bytes.  It reads and writes N * D * itemsize bytes once
// each and computes nothing: 2 * 64 MiB / 3.35 TB/s = 0.040 ms at
// [8192, 4096] bf16.
//
// Design.  The kernel moves raw bytes, so one kernel serves float32,
// bfloat16 and int32.  Rows are contiguous, so a chunk is one contiguous byte
// range; it is cut into tiles of at most 32 KiB, one slot's size, and the
// tiles of all chunks are dealt round-robin to the blocks.  Each block has its
// own two slots (64 KiB of shared memory) and walks its tiles in order: tile i
// goes through slot slot_map[chunk(i)].  While tile i drains from its slot
// to the output, tile i + 1 is already loading with cp.async, but only when
// its slot differs from tile i's; when the map sends both through one slot
// (the all-zeros map, say) the next load waits until the slot has drained.
// So every map gives a bit-exact copy.  A slot value other than 0 or 1 is
// clamped to the nearest of them.  16-byte vectors when the chunk size and
// both pointers allow it, else 4-byte words, else 2-byte halves (copied
// without cp.async, which has no 2-byte form).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kSlotBytes = 32 * 1024;
constexpr int kBlocksPerSM = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename U>
__device__ __forceinline__ void load_tile(U* dst, const U* src, int n) {
  for (int u = threadIdx.x; u < n; u += kThreads) {
    if constexpr (sizeof(U) == 16) cp_async16(dst + u, src + u);
    else if constexpr (sizeof(U) == 4) cp_async4(dst + u, src + u);
    else dst[u] = src[u];
  }
  commit();
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
relay_stage(const U* __restrict__ x, U* __restrict__ out, const int* __restrict__ slot_map,
            long long chunk_units, long long tile_units, long long tiles_per_chunk,
            long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* slots = reinterpret_cast<U*>(smem_raw);     // [2][tile_units]
  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;

  auto slot_of = [&](long long i) {
    const int s = slot_map[i / tiles_per_chunk];
    return s <= 0 ? 0 : 1;
  };
  auto offset = [&](long long i) {
    return (i / tiles_per_chunk) * chunk_units + (i % tiles_per_chunk) * tile_units;
  };
  auto length = [&](long long i) {
    return (int)min(tile_units, chunk_units - (i % tiles_per_chunk) * tile_units);
  };

  int slot = slot_of(tile);
  load_tile(slots + slot * tile_units, x + offset(tile), length(tile));
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    const int next_slot = next < n_tiles ? slot_of(next) : -1;
    const bool early = next_slot >= 0 && next_slot != slot;
    if (early) {                      // the other slot drained last iteration
      load_tile(slots + next_slot * tile_units, x + offset(next), length(next));
      wait_but_one();                 // this tile's copies are done
    } else {
      wait_all();
    }
    __syncthreads();                  // ... and everyone's are visible
    const U* src = slots + slot * tile_units;
    U* dst = out + offset(tile);
    const int n = length(tile);
    for (int u = threadIdx.x; u < n; u += kThreads) dst[u] = src[u];
    __syncthreads();                  // the slot has drained
    if (next_slot >= 0 && !early)
      load_tile(slots + next_slot * tile_units, x + offset(next), length(next));
    slot = next_slot;
  }
}

template <typename U>
int launch(const void* x, void* out, const int* slot_map, long long n_chunks,
           long long chunk_bytes, cudaStream_t s) {
  const long long chunk_units = chunk_bytes / (long long)sizeof(U);
  const long long tile_units = std::min(chunk_units, kSlotBytes / (long long)sizeof(U));
  const long long tiles_per_chunk = (chunk_units + tile_units - 1) / tile_units;
  const long long n_tiles = n_chunks * tiles_per_chunk;
  const int bytes = (int)(2 * tile_units * (long long)sizeof(U));
  int err = (int)cudaFuncSetAttribute(relay_stage<U>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const long long blocks = std::min(n_tiles, (long long)sms * kBlocksPerSM);
  relay_stage<U><<<(unsigned)blocks, kThreads, bytes, s>>>(
      static_cast<const U*>(x), static_cast<U*>(out), slot_map, chunk_units, tile_units,
      tiles_per_chunk, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n_chunks * chunk_bytes contiguous bytes; slot_map: [n_chunks] int32
// on the device.  chunk_bytes must be even.
extern "C" int relay_copy(const void* x, void* out, const int* slot_map, long long n_chunks,
                          long long chunk_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks <= 0 || chunk_bytes <= 0 || chunk_bytes % 2) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (chunk_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(x, out, slot_map, n_chunks, chunk_bytes, s);
  if (chunk_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(x, out, slot_map, n_chunks, chunk_bytes, s);
  return launch<uint16_t>(x, out, slot_map, n_chunks, chunk_bytes, s);
}
