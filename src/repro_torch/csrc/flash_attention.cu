// flash_attention — online-softmax attention with causal and sliding-window
// masks, a query position offset, and grouped-query heads.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/flash.py
// (flash_attention).  Semantics kept from it: scores are (q . k) * Dh^-0.5 in
// float32; a masked score is -1e30; the running max m, sum l and output acc are
// float32; the output is acc / max(l, 1e-30) cast to q's dtype; query head h
// reads kv head h / (H / Hkv); key kpos is visible to query qpos when
// kpos <= qpos (causal) and kpos > qpos - window (window > 0).
//
// Bound on the H100: at the slice's prefill (Sq = Sk = 512, Dh = 128) the work
// is about 4 * Dh FLOPs per visible (q, k) pair against reading q, k, v and
// writing o once; which of the two bounds it is computed per call.
//
// Design.  The TPU grid's sequential kv axis becomes a loop inside the block.
// One block of 256 threads owns (b, h, a 64-row query tile); the query tile and
// each 64-row kv tile are staged in shared memory as float32 (row pitch Dh + 1
// against bank conflicts).  Four consecutive threads share one query row: each
// computes 16 of the tile's 64 scores, the row max and sum are combined with
// warp shuffles, the probabilities go to shared memory, and each thread keeps
// Dh / 4 output columns in registers.  kv tiles that are masked for every row
// of the query tile are skipped: past the causal edge they would add
// exp(-1e30 - m) = 0, before the window they would add terms that the first
// visible tile's rescale exp(-1e30 - m) = 0 erases.  (A row that sees no key at
// all would differ; the causal prefill never has one.)  That is the float32
// route (flash_attention), on CUDA cores.
//
// The bfloat16 route (flash_attention_tc), the serving path, runs on tensor
// cores with the same semantics and tile skipping.  A block is one consumer
// warpgroup for 64 query rows plus one producer warp.  The producer loads the
// query tile once and the kv tiles into a two-stage ring by TMA, through 3-D
// tensor maps [B*H, Sq, Dh] and [B*Hkv, Sk, Dh] (128-byte swizzle), so a box
// past Sq or Sk is zero-filled and never reads the next head's rows.  The
// consumer computes S = Q K^T with wgmma (both K-major in shared memory), runs
// the online softmax on the S accumulator in registers (a row lives on a quad:
// shuffles xor 1 and 2), and feeds P as the register A operand of O += P V
// (V MN-major, B-transpose bit): twice, as its bf16 rounding and the
// rounding's residual, so P keeps about 16 bits at the cost of a second P V.
// Only edge tiles are masked: keys past Sk get -1e30 like any masked key (a
// zero-filled key is not a masked one), and rows past Sq are not stored.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr int smem_bytes() {
  return (BQ * (DH + 1) + 2 * BKV * (DH + 1) + BQ * (BKV + 1)) * (int)sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int H, int Hkv, int Sq, int Sk, float scale, int causal,
          int window, int q_offset) {
  extern __shared__ float smem[];
  constexpr int P = DH + 1;
  float* qs = smem;                 // [BQ][P]
  float* ks = qs + BQ * P;          // [BKV][P]
  float* vs = ks + BKV * P;         // [BKV][P]
  float* ps = vs + BKV * P;         // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int qr = tid / 4;           // query row within the tile
  const int quad = tid % 4;         // lane within the row's quad
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  const float* qb = q + ((long long)b * H + h) * Sq * DH;
  const float* kb = k + ((long long)b * Hkv + hk) * Sk * DH;
  const float* vb = v + ((long long)b * Hkv + hk) * Sk * DH;

  for (int l = tid; l < BQ * DH; l += kThreads) {
    const int r = l / DH, c = l % DH;
    qs[r * P + c] = (q0 + r < Sq) ? qb[(long long)(q0 + r) * DH + c] : 0.f;
  }

  // kv tiles that hold at least one visible key for some row of this tile
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_hi = Sk;
  if (causal) kv_hi = min(kv_hi, qpos_hi + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int t_lo = kv_lo / BKV;
  const int t_hi = (kv_hi + BKV - 1) / BKV;

  const int qpos = qpos_lo + qr;
  float m = kNegInf, lsum = 0.f;
  float acc[DH / 4];
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) acc[i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's ks/vs/ps reads are done
    for (int l = tid; l < BKV * DH; l += kThreads) {
      const int r = l / DH, c = l % DH;
      const bool in = k0 + r < Sk;
      ks[r * P + c] = in ? kb[(long long)(k0 + r) * DH + c] : 0.f;
      vs[r * P + c] = in ? vb[(long long)(k0 + r) * DH + c] : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int c = quad + 4 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qs[qr * P + d], ks[c * P + d], dot);
      const int kpos = k0 + c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const float p = expf(s[j] - m_new);
      ps[qr * (BKV + 1) + quad + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    lsum = lsum * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities come from the other lanes of its quad
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = ps[qr * (BKV + 1) + j];
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) acc[i] = fmaf(p, vs[j * P + quad + 4 * i], acc[i]);
    }
  }

  if (q0 + qr < Sq) {
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    float* ob = o + (((long long)b * H + h) * Sq + q0 + qr) * DH;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) ob[quad + 4 * i] = acc[i] * inv;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int Sq, int Sk, float scale, int causal, int window, int q_offset,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes<DH>();
  int err = (int)cudaFuncSetAttribute(flash_fwd<DH>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<DH><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, Sq, Sk, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ========================== bfloat16: tensor cores ===========================

namespace tc {

constexpr int kThreads = 160;             // warps 0-3 consume (wgmma), warp 4 loads
constexpr int kStages = 2;                // kv ring
constexpr int kBox = 64 * 64 * 2;         // one TMA box, 64 rows x 128 bytes: 8 KiB

template <int DH>
struct Cfg {
  static constexpr int kTile = DH / 64 * kBox;  // [64 rows][DH] as DH / 64 boxes
  // Q, the ring of (K, V) stages, 1 KiB of alignment slack, the barriers
  static constexpr int kSmem = kTile + kStages * 2 * kTile + 1024 + (1 + 2 * kStages) * 8;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
         const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int H,
         int Hkv, int Sq, int Sk, float scale, int causal, int window, int q_offset) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  // kv tiles that hold at least one visible key for some row of this tile
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_hi = Sk;
  if (causal) kv_hi = min(kv_hi, qpos_hi + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int t_lo = kv_lo / BKV;
  const int n_t = max(0, (kv_hi + BKV - 1) / BKV - t_lo);

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = sq + C::kTile;            // stage s: K at ring + 2 s kTile, V after it
  const uint32_t qbar = ring + kStages * 2 * C::kTile;
  const uint32_t full = qbar + 8, empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);    // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer: Q once, then K and V tiles into the ring ----
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, C::kTile);      // the whole box, zero-filled part included
#pragma unroll
      for (int c = 0; c < DH / 64; ++c)
        tma_load_3d(sq + c * kBox, &map_q, qbar, 64 * c, q0, b * H + h);
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kStages;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s, sk = ring + 2 * s * C::kTile;
        mbar_arrive_expect_tx(bar, 2 * C::kTile);
        const int k0 = (t_lo + i) * BKV;
#pragma unroll
        for (int c = 0; c < DH / 64; ++c) {
          tma_load_3d(sk + c * kBox, &map_k, bar, 64 * c, k0, b * Hkv + hk);
          tma_load_3d(sk + C::kTile + c * kBox, &map_v, bar, 64 * c, k0, b * Hkv + hk);
        }
      }
    }
  } else {
    // ---- consumer warpgroup ----
    const int r = 16 * warp + lane / 4;           // rows r and r + 8 of the tile
    const int cq = 2 * (lane % 4);                // column offset in each group of 8
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};  // lsum: this lane's part
    mbar_wait(qbar, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kStages;
      const int k0 = (t_lo + i) * BKV;
      const uint32_t sk = ring + 2 * s * C::kTile, sv = sk + C::kTile;
      mbar_wait(full + 8 * s, (i / kStages) & 1);

      float sc[BKV / 2];                          // S = Q K^T, 64 x 64
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_m64n64k16_ss<0>(sc, desc_kmajor(sq, kk, kBox), desc_kmajor(sk, kk, kBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      // masks only on edge tiles: past Sk, across the causal edge, before the window
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > qpos_lo) ||
                        (window > 0 && k0 <= qpos_hi - window);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = sc[4 * j + 2 * hr + c] * scale;
            if (edge) {
              const int kpos = k0 + 8 * j + cq + c, qpos = qpos_lo + r + 8 * hr;
              bool ok = kpos < Sk;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              v = ok ? v : kNegInf;
            }
            sc[4 * j + 2 * hr + c] = v;
            mt[hr] = fmaxf(mt[hr], v);
          }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
        mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
        const float m_new = fmaxf(m[hr], mt[hr]);
        alpha[hr] = __expf(m[hr] - m_new);
        m[hr] = m_new;
        lsum[hr] *= alpha[hr];
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = __expf(sc[4 * j + 2 * hr + c] - m[hr]);
            sc[4 * j + 2 * hr + c] = p;
            lsum[hr] += p;
          }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          acc[4 * j + 2 * hr] *= alpha[hr];
          acc[4 * j + 2 * hr + 1] *= alpha[hr];
        }
      // P as bf16 A fragments of the tile's four k16 steps over keys, in the
      // order (r, 2q), (r + 8, 2q), (r, 8 + 2q), (r + 8, 8 + 2q), each with the
      // next key.  P goes in twice, its bf16 rounding and the rounding's
      // residual, so it keeps about 16 bits: P rounded once moves outputs by
      // a bf16 ulp where the f32 route does not.
      uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p0 = sc[8 * kk + 2 * q], p1 = sc[8 * kk + 2 * q + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][q] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][q] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }

      wgmma_fence();                              // O += P V
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = desc_mnmajor(sv, kk, kBox);
        if constexpr (DH == 128) {
          wgmma_m64n128k16_rs<1>(acc, ph[kk], dv, 1);
          wgmma_m64n128k16_rs<1>(acc, pl[kk], dv, 1);
        } else {
          wgmma_m64n64k16_rs<1>(acc, ph[kk], dv, 1);
          wgmma_m64n64k16_rs<1>(acc, pl[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = lsum[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = q0 + r + 8 * hr;
      if (row >= Sq) continue;
      __nv_bfloat16* ob = o + (((long long)b * H + h) * Sq + row) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j + cq) =
            pack_bf16(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
           int Sk, float scale, int causal, int window, int q_offset, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(flash_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      Cfg<DH>::kSmem);
  if (err) return err;
  CUtensorMap mq, mk, mv;
  const uint64_t dq[3] = {(uint64_t)DH, (uint64_t)Sq, (uint64_t)B * H};
  const uint64_t dk[3] = {(uint64_t)DH, (uint64_t)Sk, (uint64_t)B * Hkv};
  err = encode_bf16_map(&mq, q, 3, dq, 64);
  if (!err) err = encode_bf16_map(&mk, k, 3, dk, 64);
  if (!err) err = encode_bf16_map(&mv, v, 3, dk, 64);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_tc<DH><<<grid, kThreads, Cfg<DH>::kSmem, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Sk, scale, causal, window,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 route.  q [B, H, Sq, Dh], k/v [B, Hkv, Sk, Dh], o [B, H, Sq, Dh], all
// contiguous float32.  Dh must be 64 or 128; window <= 0 means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Hkv, int Sq, int Sk, int Dh, float scale,
                               int causal, int window, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  if (Dh == 128)
    return launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

// bfloat16 route on tensor cores: the same arguments, all bfloat16, with
// 16-byte aligned pointers.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int Hkv, int Sq, int Sk, int Dh, float scale,
                                  int causal, int window, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return tc::launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  if (Dh == 128)
    return tc::launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
