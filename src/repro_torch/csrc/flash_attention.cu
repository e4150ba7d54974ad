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
// all would differ; the causal prefill never has one.)  CUDA cores only; tensor
// cores and TMA are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr int smem_bytes() {
  return (BQ * (DH + 1) + 2 * BKV * (DH + 1) + BQ * (BKV + 1)) * (int)sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int Hkv, int Sq, int Sk, float scale, int causal,
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

  const T* qb = q + ((long long)b * H + h) * Sq * DH;
  const T* kb = k + ((long long)b * Hkv + hk) * Sk * DH;
  const T* vb = v + ((long long)b * Hkv + hk) * Sk * DH;

  for (int l = tid; l < BQ * DH; l += kThreads) {
    const int r = l / DH, c = l % DH;
    qs[r * P + c] = (q0 + r < Sq) ? to_f32(qb[(long long)(q0 + r) * DH + c]) : 0.f;
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
      ks[r * P + c] = in ? to_f32(kb[(long long)(k0 + r) * DH + c]) : 0.f;
      vs[r * P + c] = in ? to_f32(vb[(long long)(k0 + r) * DH + c]) : 0.f;
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
    T* ob = o + (((long long)b * H + h) * Sq + q0 + qr) * DH;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) ob[quad + 4 * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int Sq, int Sk, float scale, int causal, int window, int q_offset,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes<DH>();
  int err = (int)cudaFuncSetAttribute(flash_fwd<T, DH>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DH><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
              int Sq, int Sk, int Dh, float scale, int causal, int window, int q_offset,
              cudaStream_t s) {
  if (Dh == 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  if (Dh == 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, Sq, Dh], k/v [B, Hkv, Sk, Dh], o [B, H, Sq, Dh], all contiguous and
// of dtype `dtype`.  Dh must be 64 or 128; window <= 0 means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Hkv, int Sq, int Sk, int Dh, float scale,
                               int causal, int window, int q_offset, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, scale, causal, window,
                                    q_offset, s);
  return launch_dh<float>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, scale, causal, window, q_offset,
                          s);
}
