// relay_copy — identity copy of [N, D] through two shared-memory staging slots.
//
// Replaces the Pallas TPU kernel repro/kernels/relay_copy/relay.py
// (relay_copy), the staging discipline of the paper's relay buffers (§IV-C):
// a large buffer moves chunk by chunk (block_chunk rows) through a small
// window of two slots, and the slot each chunk passes through is runtime
// data, slot_map[chunk], so a new schedule re-targets slots without a new
// kernel (the map is a device pointer the host never reads).  A slot value
// other than 0 or 1 is clamped to the nearest of them.
//
// Bound on the H100: bytes.  It reads and writes N * D * itemsize bytes once
// each and computes nothing: 2 * 64 MiB / 3.35 TB/s = 0.040 ms at
// [8192, 4096] bf16.
//
// Design.  The kernel moves raw bytes, so one kernel serves float32,
// bfloat16 and int32.  Rows are contiguous, so a chunk is one contiguous
// byte range, cut into tiles of equal size (the last of a chunk shorter).
//
// The bulk route (chunk size and both pointers 16-byte aligned) moves every
// byte with Hopper's bulk-copy engine, and no thread touches the data: one
// thread a block loads a tile into its slot with
// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes (an
// mbarrier a slot completes the transaction), then drains the slot to the
// output with cp.async.bulk.global.shared::cta.bulk_group, and waits with
// cp.async.bulk.wait_group.read only before a slot is refilled.  While tile
// i drains from its slot, tile i + 1 is already loading, but only when its
// slot differs from tile i's; when the map sends both through one slot (the
// all-zeros map, say) the next load waits until the slot has been read.  So
// every map gives a bit-exact copy.
//
// The route is set by the HBM pipe, not by the SMs: the copy needs about
// 25 GB/s a SM each way, so a few tens of KiB in flight a SM keep HBM busy
// at its latency.  Each block keeps exactly two slots of at most 96 KiB
// (192 KiB of the 227 KiB an SM has), so one block a SM holds a load and a
// store of up to 96 KiB each in flight.  On the card, a second or third
// block a SM, tiles of 16 to 96 KiB, a tile split into several bulk copies,
// L2 prefetches of the next tiles and evict-first hints gained nothing, nor
// did loading or storing through the threads instead of the engine
// (`chip_smoke.py` phase 13 times the kept design).  Tiles are dealt
// round-robin in address order (tile s is tile s mod tiles_per_chunk of
// chunk s / tiles_per_chunk), so at any moment the blocks work on one
// contiguous window of the buffer; dealing them chunk by chunk across the
// whole buffer instead timed slower.  The grid is one block a SM, and a
// block's consecutive tiles lie gridDim.x tiles apart; the wrapper
// (kernels/relay_copy/ops.py, `geometry`) takes the tile size for which the
// busiest block moves about the average's bytes.  At [8192, 4096] bf16 in
// chunks of 256 rows on 132 SMs that is 45 tiles of 46,608 bytes a chunk,
// and under the parity map 42 of 45 of a block's consecutive tiles take
// different slots.
//
// The word routes (a chunk size or pointer not 16-byte aligned) keep the
// first design: 256 threads copy 4-byte words (cp.async) or 2-byte halves
// (plain loads) through two 32 KiB slots, 3 blocks a SM, tiles dealt in the
// same address order.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr long long kMaxTile = 96 * 1024;        // bulk route: one slot (ops.py: SLOT_BYTES)
constexpr int kBulkSmem = 2 * kMaxTile + 16;     // two slots and their two mbarriers
constexpr int kThreads = 256;                    // word routes
constexpr long long kWordTile = 32 * 1024;       // word routes: one slot (WORD_SLOT_BYTES)
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(32)
relay_bulk(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
           const int* __restrict__ slot_map, long long n_chunks, long long chunk_bytes,
           long long tile_bytes, long long tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;                  // one thread moves every tile
  const long long n_tiles = n_chunks * tiles_per_chunk;
  long long s = blockIdx.x;
  if (s >= n_tiles) return;
  const uint32_t slots = smem_u32(smem);
  const uint32_t bars = slots + 2 * (uint32_t)tile_bytes;
  mbar_init(bars, 1);
  mbar_init(bars + 8, 1);
  mbar_fence_init();
  uint32_t phase[2] = {0, 0};

  auto slot_of = [&](long long t) { return slot_map[t / tiles_per_chunk] <= 0 ? 0 : 1; };
  auto offset = [&](long long t) {
    return (t / tiles_per_chunk) * chunk_bytes + (t % tiles_per_chunk) * tile_bytes;
  };
  auto length = [&](long long t) {
    return (uint32_t)min(tile_bytes, chunk_bytes - (t % tiles_per_chunk) * tile_bytes);
  };
  auto load = [&](long long t, int slot) {
    const uint32_t bar = bars + 8 * slot, bytes = length(t);
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load(slots + slot * (uint32_t)tile_bytes, x + offset(t), bytes, bar);
  };

  int slot = slot_of(s);
  load(s, slot);
  for (; s < n_tiles; s += gridDim.x) {
    const long long next = s + gridDim.x;
    const int next_slot = next < n_tiles ? slot_of(next) : -1;
    const bool early = next_slot >= 0 && next_slot != slot;
    if (early) {                  // the other slot: free once the last store has read it
      bulk_wait_read<0>();
      load(next, next_slot);
    }
    mbar_wait(bars + 8 * slot, phase[slot]);
    phase[slot] ^= 1;
    fence_proxy_async();
    bulk_store(out + offset(s), slots + slot * (uint32_t)tile_bytes, length(s));
    bulk_commit();
    if (next_slot >= 0 && !early) {   // the same slot: refill once this store has read it
      bulk_wait_read<0>();
      load(next, next_slot);
    }
    slot = next_slot;
  }
  bulk_wait<0>();                     // every store written before the block ends
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
    if constexpr (sizeof(U) == 4) cp_async4(dst + u, src + u);
    else dst[u] = src[u];
  }
  commit();
}

// U: uint32_t or uint16_t.  Tiles in address order, dealt round-robin.
template <typename U>
__global__ void __launch_bounds__(kThreads)
relay_words(const U* __restrict__ x, U* __restrict__ out, const int* __restrict__ slot_map,
            long long chunk_units, long long tile_units, long long tiles_per_chunk,
            long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* slots = reinterpret_cast<U*>(smem_raw);     // [2][tile_units]
  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;

  auto slot_of = [&](long long i) { return slot_map[i / tiles_per_chunk] <= 0 ? 0 : 1; };
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

// the dynamic shared-memory attribute of each kernel, set once a device
template <int K>
int ready(const void* kernel, int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    done[dev] = true;
  }
  return 0;
}

template <typename U>
int launch_words(const void* x, void* out, const int* slot_map, long long n_chunks,
                 long long chunk_bytes, long long tile_bytes, long long tiles_per_chunk,
                 long long blocks, cudaStream_t s) {
  int err = ready<sizeof(U)>(reinterpret_cast<const void*>(relay_words<U>),
                             (int)(2 * kWordTile));
  if (err) return err;
  const long long w = sizeof(U);
  relay_words<U><<<(unsigned)blocks, kThreads, (int)(2 * tile_bytes), s>>>(
      static_cast<const U*>(x), static_cast<U*>(out), slot_map, chunk_bytes / w,
      tile_bytes / w, tiles_per_chunk, n_chunks * tiles_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n_chunks * chunk_bytes contiguous bytes; slot_map: [n_chunks]
// int32 on the device.  The geometry comes from ops.py's `geometry`: word 16
// takes the bulk route (chunk_bytes and both pointers 16-byte aligned, tiles
// of at most 96 KiB, a multiple of 16), word 4 or 2 the word routes (tiles
// of at most 32 KiB); tiles_per_chunk tiles of tile_bytes cover a chunk, the
// last one shorter; `blocks` blocks.
extern "C" int relay_copy(const void* x, void* out, const int* slot_map, long long n_chunks,
                          long long chunk_bytes, int word, long long tile_bytes,
                          long long tiles_per_chunk, long long blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  const long long max_tile = word == 16 ? kMaxTile : kWordTile;
  const bool ok = (word == 16 || word == 4 || word == 2) && n_chunks > 0 &&
                  chunk_bytes > 0 && chunk_bytes % word == 0 && align % word == 0 &&
                  tile_bytes > 0 && tile_bytes % word == 0 && tile_bytes <= max_tile &&
                  tiles_per_chunk >= 1 && (tiles_per_chunk - 1) * tile_bytes < chunk_bytes &&
                  tiles_per_chunk * tile_bytes >= chunk_bytes && blocks >= 1 &&
                  blocks <= 2147483647LL;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (word == 4)
    return launch_words<uint32_t>(x, out, slot_map, n_chunks, chunk_bytes, tile_bytes,
                                  tiles_per_chunk, blocks, s);
  if (word == 2)
    return launch_words<uint16_t>(x, out, slot_map, n_chunks, chunk_bytes, tile_bytes,
                                  tiles_per_chunk, blocks, s);
  int err = ready<16>(reinterpret_cast<const void*>(relay_bulk), kBulkSmem);
  if (err) return err;
  relay_bulk<<<(unsigned)blocks, 32, (int)(2 * tile_bytes + 16), s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), slot_map,
      n_chunks, chunk_bytes, tile_bytes, tiles_per_chunk);
  return (int)cudaGetLastError();
}
