// mlstm_scan — the chunkwise-parallel, stabilized mLSTM recurrence.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_scan/scan.py
// (mlstm_scan), which computes the exact chunk recurrence of the reference's
// models/xlstm.py::_mlstm_chunk_body.  Per (batch, head) and chunk of L steps,
// with the carried state (C [dh, dh], n [dh], m):
//
//   Lf = cumsum(lf),  g = ig - Lf,  u_t = max(m_in, cummax_{j<=t} g_j)
//   S[t, j] = (q_t . k_j) e^{g_j - u_t}           (j <= t, else 0)
//   den_t = sum_j S[t, j] + e^{m_in - u_t} q_t . n_in
//   h_t = (S v + e^{m_in - u_t} q_t C_in)_t / max(|den_t|, e^{-(Lf_t + u_t)})
//   C' = e^{m_in - u_L} C_in + sum_j e^{g_j - u_L} k_j v_j^T,  n' likewise,
//   m' = Lf_L + u_L.
//
// Unlike the TPU kernel it starts from a given state (or the zero state with
// m = -30 when none is given) and writes the final one, so
// mlstm_forward_chunked(state=...) runs through it.
//
// Bound on the H100 at xlstm-125m's prefill (B 4, H 4, S 2048, dh 192, L 64):
// operations.  Per chunk the work is q k^T and S v over the causal half of
// L x L, plus q C_in and the k^T v update at L x dh x dh: about 5.6 GFLOP a
// launch in float32, 0.084 ms at 67 TFLOP/s on CUDA cores, against 103 MB
// moved (q, k, v in, h out), 0.031 ms at 3.35 TB/s.
//
// Design.  The TPU grid's sequential chunk axis becomes a loop inside the
// block, with the state in shared memory across it.  C alone is 144 KiB at
// dh = 192, so the value dimension p is split across blocks: a block of 256
// threads owns (b, h, a 32-column slice of p), keeps C[:, slice], v[:, slice]
// and h[:, slice], and recomputes the p-independent scores, gates and
// denominators (grid dh/32 x H x B, 96 blocks at the prefill).  One warp
// computes the chunk's prefix sum and prefix max with shuffles.  q and k are
// staged with a row pitch of dh + 1 against bank conflicts.  Masked weights
// are exactly 0, as e^{-inf} is in the reference; padded steps carry
// ig = -1e30, so their weights are 0 too.  CUDA cores only, in float32.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 64;
constexpr int kMaxDh = 192;
constexpr int kPS = 32;                    // value columns per block
constexpr float kNeg = -1e30f;

__host__ __device__ inline int smem_floats(int L, int dh) {
  return 2 * L * (dh + 1)    // q, k
         + L * kPS           // v slice
         + dh * kPS          // C slice
         + L * (L + 1)       // weighted scores
         + dh                // n
         + 6 * kMaxL         // Lf, g, u, w_in, den, wj
         + 4;                // m_in, decay, m_out
}

__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunks(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ ig,
             const float* __restrict__ lf, const float* __restrict__ C0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ h, float* __restrict__ C1, float* __restrict__ n1,
             float* __restrict__ m1, int H, int S, int dh, int L) {
  extern __shared__ float smem[];
  const int QP = dh + 1;
  float* qs = smem;                   // [L][QP]
  float* ks = qs + L * QP;            // [L][QP]
  float* vs = ks + L * QP;            // [L][kPS]
  float* cs = vs + L * kPS;           // [dh][kPS]
  float* ss = cs + dh * kPS;          // [L][L + 1]
  float* ns = ss + L * (L + 1);       // [dh]
  float* lf_s = ns + dh;              // [kMaxL] Lf
  float* g_s = lf_s + kMaxL;          // g = ig - Lf
  float* u_s = g_s + kMaxL;           // u
  float* win_s = u_s + kMaxL;         // e^{m_in - u}
  float* den_s = win_s + kMaxL;       // max(|den|, e^{-m})
  float* wj_s = den_s + kMaxL;        // e^{g_j - u_L}
  float* sc = wj_s + kMaxL;           // [0] m_in, [1] decay, [2] m_out

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int p0 = blockIdx.x * kPS;
  const int pw = min(kPS, dh - p0);
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * S * dh;
  const float* kb = k + bh * S * dh;
  const float* vb = v + bh * S * dh;
  const float* igb = ig + bh * S;
  const float* lfb = lf + bh * S;
  float* hb = h + bh * S * dh;

  for (int l = tid; l < dh * kPS; l += kThreads) {
    const int d = l / kPS, p = l % kPS;
    cs[l] = (C0 != nullptr && p < pw) ? C0[bh * dh * dh + (long long)d * dh + p0 + p] : 0.f;
  }
  for (int d = tid; d < dh; d += kThreads) ns[d] = (n0 != nullptr) ? n0[bh * dh + d] : 0.f;
  if (tid == 0) sc[0] = (m0 != nullptr) ? m0[bh] : -30.f;

  // thread roles: rows of the chunk for the scores and the output ...
  const int t = tid / 4;              // chunk row (L <= 64 = kThreads / 4)
  const int quad = tid % 4;
  const bool row_ok = t < L;
  // ... and (d, p) cells of the C slice for the state update
  const int cp = tid % kPS;
  const int cd = tid / kPS;           // 0..7

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();                  // the previous chunk is done with smem
    for (int l = tid; l < L * dh; l += kThreads) {
      const int r = l / dh, c = l % dh;
      qs[r * QP + c] = qb[(long long)t0 * dh + l];
      ks[r * QP + c] = kb[(long long)t0 * dh + l];
    }
    for (int l = tid; l < L * kPS; l += kThreads) {
      const int r = l / kPS, c = l % kPS;
      vs[l] = c < pw ? vb[(long long)(t0 + r) * dh + p0 + c] : 0.f;
    }
    if (tid < 32) {
      // gates: lane holds steps 2 lane and 2 lane + 1
      const float m_in = sc[0];
      const int i0 = 2 * lane, i1 = 2 * lane + 1;
      const float a0 = i0 < L ? lfb[t0 + i0] : 0.f;
      float a1 = i1 < L ? lfb[t0 + i1] : 0.f;
      a1 += a0;
      float run = a1;                 // inclusive prefix sum of the pair totals
      for (int o = 1; o < 32; o *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, run, 1);   // sum over earlier lanes
      if (lane == 0) excl = 0.f;
      const float Lf0 = a0 + excl, Lf1 = a1 + excl;
      const float g0 = i0 < L ? igb[t0 + i0] - Lf0 : kNeg;
      const float g1 = i1 < L ? igb[t0 + i1] - Lf1 : kNeg;
      const float b1 = fmaxf(g0, g1);
      float mx = b1;                  // inclusive prefix max of the pair maxima
      for (int o = 1; o < 32; o *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, mx, o);
        if (lane >= o) mx = fmaxf(mx, y);
      }
      float before = __shfl_up_sync(0xffffffffu, mx, 1);
      if (lane == 0) before = kNeg;
      const float u0 = fmaxf(m_in, fmaxf(g0, before));
      const float u1 = fmaxf(m_in, fmaxf(b1, before));
      if (i0 < L) {
        lf_s[i0] = Lf0; g_s[i0] = g0; u_s[i0] = u0;
        win_s[i0] = expf(m_in - u0);
      }
      if (i1 < L) {
        lf_s[i1] = Lf1; g_s[i1] = g1; u_s[i1] = u1;
        win_s[i1] = expf(m_in - u1);
      }
      __syncwarp();
      const float uL = u_s[L - 1];
      if (i0 < L) wj_s[i0] = expf(g_s[i0] - uL);
      if (i1 < L) wj_s[i1] = expf(g_s[i1] - uL);
      if (lane == 0) {
        sc[1] = expf(m_in - uL);
        sc[2] = lf_s[L - 1] + uL;
      }
    }
    __syncthreads();

    // scores S[t, j] for j = quad + 4 jj <= t, their row sums, and q_t . n_in
    {
      float s[kMaxL / 4];
#pragma unroll
      for (int jj = 0; jj < kMaxL / 4; ++jj) s[jj] = 0.f;
      float qn = 0.f;
      if (row_ok) {
        for (int d = 0; d < dh; ++d) {
          const float qv = qs[t * QP + d];
#pragma unroll
          for (int jj = 0; jj < kMaxL / 4; ++jj) {
            const int j = quad + 4 * jj;
            if (j <= t) s[jj] = fmaf(qv, ks[j * QP + d], s[jj]);
          }
        }
        for (int d = quad; d < dh; d += 4) qn = fmaf(qs[t * QP + d], ns[d], qn);
      }
      float rs = 0.f;
      if (row_ok) {
        const float ut = u_s[t];
#pragma unroll
        for (int jj = 0; jj < kMaxL / 4; ++jj) {
          const int j = quad + 4 * jj;
          if (j < L) {
            const float w = j <= t ? s[jj] * expf(g_s[j] - ut) : 0.f;
            ss[t * (L + 1) + j] = w;
            rs += w;
          }
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      qn += __shfl_xor_sync(0xffffffffu, qn, 1);
      qn += __shfl_xor_sync(0xffffffffu, qn, 2);
      if (row_ok && quad == 0) {
        const float den = rs + win_s[t] * qn;
        den_s[t] = fmaxf(fabsf(den), expf(-(lf_s[t] + u_s[t])));
      }
    }
    __syncthreads();

    // h[t, p] = (S v + e^{m_in - u_t} q_t C_in)[p] / den_t, p = quad + 4 i
    if (row_ok) {
      float acc[kPS / 4], accc[kPS / 4];
#pragma unroll
      for (int i = 0; i < kPS / 4; ++i) acc[i] = accc[i] = 0.f;
      for (int j = 0; j <= t; ++j) {
        const float w = ss[t * (L + 1) + j];
#pragma unroll
        for (int i = 0; i < kPS / 4; ++i) acc[i] = fmaf(w, vs[j * kPS + quad + 4 * i], acc[i]);
      }
      for (int d = 0; d < dh; ++d) {
        const float qv = qs[t * QP + d];
#pragma unroll
        for (int i = 0; i < kPS / 4; ++i) accc[i] = fmaf(qv, cs[d * kPS + quad + 4 * i], accc[i]);
      }
      const float w_in = win_s[t], den = den_s[t];
      float* hrow = hb + (long long)(t0 + t) * dh + p0;
#pragma unroll
      for (int i = 0; i < kPS / 4; ++i) {
        const int p = quad + 4 * i;
        if (p < pw) hrow[p] = (acc[i] + w_in * accc[i]) / den;
      }
    }
    __syncthreads();

    // state update: k_j scaled by e^{g_j - u_L}, then C and n
    for (int l = tid; l < L * dh; l += kThreads) {
      const int r = l / dh, c = l % dh;
      ks[r * QP + c] *= wj_s[r];
    }
    __syncthreads();
    {
      const float decay = sc[1];
      float acc[kMaxDh / 8];
#pragma unroll
      for (int i = 0; i < kMaxDh / 8; ++i) acc[i] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float vv = vs[j * kPS + cp];
#pragma unroll
        for (int i = 0; i < kMaxDh / 8; ++i) {
          const int d = cd + 8 * i;
          if (d < dh) acc[i] = fmaf(ks[j * QP + d], vv, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxDh / 8; ++i) {
        const int d = cd + 8 * i;
        if (d < dh) cs[d * kPS + cp] = decay * cs[d * kPS + cp] + acc[i];
      }
      for (int d = tid; d < dh; d += kThreads) {
        float sum = 0.f;
        for (int j = 0; j < L; ++j) sum += ks[j * QP + d];
        ns[d] = decay * ns[d] + sum;
      }
      if (tid == 0) sc[0] = sc[2];
    }
  }
  __syncthreads();

  for (int l = tid; l < dh * kPS; l += kThreads) {
    const int d = l / kPS, p = l % kPS;
    if (p < pw) C1[bh * dh * dh + (long long)d * dh + p0 + p] = cs[l];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += kThreads) n1[bh * dh + d] = ns[d];
    if (tid == 0) m1[bh] = sc[0];
  }
}

}  // namespace

// q, k, v, h [B, H, S, dh]; ig, lf [B, H, S]; C [B, H, dh, dh]; n [B, H, dh];
// m [B, H]; all float32 and contiguous.  S must be a multiple of L, with
// 1 <= L <= 64 and 1 <= dh <= 192.  C0, n0 and m0 may all be NULL: the zero
// state with m = -30.  C1, n1 and m1 receive the final state.
extern "C" int mlstm_scan(const float* q, const float* k, const float* v, const float* ig,
                          const float* lf, const float* C0, const float* n0,
                          const float* m0, float* h, float* C1, float* n1, float* m1,
                          int B, int H, int S, int dh, int L, void* stream) {
  if (L < 1 || L > kMaxL || dh < 1 || dh > kMaxDh || S % L != 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_floats(L, dh) * (int)sizeof(float);
  int err = (int)cudaFuncSetAttribute(mlstm_chunks,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((dh + kPS - 1) / kPS, H, B);
  mlstm_chunks<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, ig, lf, C0, n0, m0, h, C1, n1, m1, H, S, dh, L);
  return (int)cudaGetLastError();
}
