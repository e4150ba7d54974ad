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
// call in float32, 0.084 ms at 67 TFLOP/s on CUDA cores, against 103 MB
// moved (q, k, v in, h out), 0.031 ms at 3.35 TB/s.
//
// Design: three launches, and only a scalar chain and an elementwise pass
// are sequential over chunks.  Write G = max_j g_j, the chunk's own
// stabilizer, and u_L = max(m_in, G).  Then e^{g_j - u_L} = e^{g_j - G}
// e^{G - u_L}, so each chunk's state update is computed in parallel at its
// own stabilizer and scaled once the chain is known:
//
//   1. mlstm_delta, a block per (b, h, chunk): k and v of the chunk come
//      into shared memory by cp.async while one warp computes the chunk's
//      gates (Lf, g, G; prefix sum and max by shuffles); then
//      dC'[d, p] = sum_j e^{g_j - G} k_j[d] v_j[p] in tiles of 64 rows of
//      d, as a register-tiled f32 product (8 x 6 outputs a thread, operands
//      read from shared memory as float4 and float2), and dn', into a
//      scratch tensor [B, H, chunks, dh * dh + dh] that the wrapper
//      allocates.  It writes (Lf_L, G) of each chunk.
//   2. mlstm_prefix, a block per (b, h, 256 threads of state elements, 4 a
//      thread as a float4 where dh % 4 == 0): thread 0 runs
//      the stabilizer chain in chunk order (u_L = max(m, G),
//      decay = e^{m - u_L}, scale = e^{G - u_L}, m <- Lf_L + u_L) over
//      factors staged in shared memory; then every thread walks its element
//      through the chunks (8 loads in flight), replacing dC'_c by C_in of
//      chunk c in place and writing the final C and n.  Each chunk's m_in
//      and the final m go out too.
//   3. mlstm_out, a block per (b, h, chunk): q k^T once per chunk (not once
//      per value slice), masked and weighted into S, the denominators, then
//      h = [S | w_in q] [v ; C_in] as one product of depth L + dh.  The B
//      operands (k^T, then [v ; C_in]) stream through a two-stage shared
//      ring of 16-row slices by cp.async, the next slice loading while this
//      one is used; q^T and S^T stay in shared memory.
//
// Rows and columns are 16-byte vectors where dh % 4 == 0 (the serving
// path's 192), 4-byte words otherwise.
// Masked weights are exactly 0 (selected, not multiplied), as e^{-inf} is in
// the reference; padded steps carry ig = -1e30, so their weights are 0 too.
// CUDA cores only, in float32.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 64;
constexpr int kMaxDh = 192;
constexpr int kAP = kMaxL + 4;      // pitch of the operands indexed by t or d (float4 rows)
constexpr int kBP = kMaxDh + 4;     // pitch of the operands indexed by p
constexpr int kKS = 16;             // rows of a streamed B slice
constexpr int kChain = 1024;        // chunks of the chain held in shared memory at once
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The chunk's own gates, by one warp: Lf (inclusive prefix sum of lf),
// g = ig - Lf and cm = cummax g (without m_in), for steps t < L.  Lane l
// holds steps 2 l and 2 l + 1.
__device__ void chunk_gates(const float* __restrict__ ig, const float* __restrict__ lf,
                            int L, float* lf_s, float* g_s, float* cm_s) {
  const int lane = threadIdx.x % 32;
  const int i0 = 2 * lane, i1 = 2 * lane + 1;
  const float a0 = i0 < L ? lf[i0] : 0.f;
  float a1 = i1 < L ? lf[i1] : 0.f;
  a1 += a0;
  float run = a1;                   // inclusive prefix sum of the pair totals
  for (int o = 1; o < 32; o *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) excl = 0.f;
  const float Lf0 = a0 + excl, Lf1 = a1 + excl;
  const float g0 = i0 < L ? ig[i0] - Lf0 : kNeg;
  const float g1 = i1 < L ? ig[i1] - Lf1 : kNeg;
  const float b1 = fmaxf(g0, g1);
  float mx = b1;                    // inclusive prefix max of the pair maxima
  for (int o = 1; o < 32; o *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, mx, o);
    if (lane >= o) mx = fmaxf(mx, y);
  }
  float before = __shfl_up_sync(0xffffffffu, mx, 1);
  if (lane == 0) before = kNeg;
  if (i0 < L) { lf_s[i0] = Lf0; g_s[i0] = g0; cm_s[i0] = fmaxf(g0, before); }
  if (i1 < L) { lf_s[i1] = Lf1; g_s[i1] = g1; cm_s[i1] = fmaxf(b1, before); }
}

// acc[r][i] += a[r] b[i] for one step of depth: a = 8 consecutive floats at A
// (the warp's rows, a broadcast), b = 6 columns at B + 2 lane + 64 (i / 2).
__device__ __forceinline__ void fma_8x6(const float* A, const float* B, int lane,
                                        float (&acc)[8][6]) {
  const float4 x0 = *reinterpret_cast<const float4*>(A);
  const float4 x1 = *reinterpret_cast<const float4*>(A + 4);
  const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  float b[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float2 y = *reinterpret_cast<const float2*>(B + 2 * lane + 64 * i);
    b[2 * i] = y.x;
    b[2 * i + 1] = y.y;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[r][i] = fmaf(a[r], b[i], acc[r][i]);
}

// The same with 2 columns, at B + 2 lane.
__device__ __forceinline__ void fma_8x2(const float* A, const float* B, int lane,
                                        float (&acc)[8][2]) {
  const float4 x0 = *reinterpret_cast<const float4*>(A);
  const float4 x1 = *reinterpret_cast<const float4*>(A + 4);
  const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float2 y = *reinterpret_cast<const float2*>(B + 2 * lane);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    acc[r][0] = fmaf(a[r], y.x, acc[r][0]);
    acc[r][1] = fmaf(a[r], y.y, acc[r][1]);
  }
}

// cp.async of 4 or 16 bytes into shared memory; a false predicate copies
// nothing from `src` and writes zeros.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, rows) of a [*, dh] float32 matrix into shared rows of pitch kBP;
// kVec: dh % 4 == 0 and 16-byte aligned rows, copied 16 bytes at a time.
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int dh) {
  if (kVec) {
    const int q = dh / 4;
    for (int e = threadIdx.x; e < rows * q; e += kThreads) {
      const int r = e / q, c = 4 * (e % q);
      cp_async16(dst + r * kBP + c, src + (long long)r * dh + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
      const int r = e / dh, c = e % dh;
      cp_async4(dst + r * kBP + c, src + (long long)r * dh + c, true);
    }
  }
}

constexpr int kDeltaSmem = (2 * kMaxL * kBP + 4 * kMaxL) * 4;

// 1. dC'_c = sum_j e^{g_j - G} k_j v_j^T and dn'_c, each chunk at its own G.
// grid (chunks, B * H); the block walks dC' in tiles of 64 rows of d.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_delta(const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ ig, const float* __restrict__ lf,
            float* __restrict__ work, float2* __restrict__ sc, int S, int dh, int L) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [L][kBP]: e^{g_j - G} k[j][d]
  float* Bs = As + kMaxL * kBP;                  // [L][kBP]: v[j][p]
  float* lf_s = Bs + kMaxL * kBP;
  float* g_s = lf_s + kMaxL;
  float* cm_s = g_s + kMaxL;
  float* a_s = cm_s + kMaxL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, NC = gridDim.x;
  const long long bh = blockIdx.y;
  const long long row0 = bh * S + (long long)c * L;

  stage_rows<kVec>(As, k + row0 * dh, L, dh);
  stage_rows<kVec>(Bs, v + row0 * dh, L, dh);
  cp_commit();
  if (warp == 0) {
    chunk_gates(ig + row0, lf + row0, L, lf_s, g_s, cm_s);
    __syncwarp();
    const float G = cm_s[L - 1];
    for (int j = lane; j < L; j += 32) a_s[j] = expf(g_s[j] - G);
    if (lane == 0) sc[bh * NC + c] = make_float2(lf_s[L - 1], G);
  }
  cp_wait_all();
  __syncthreads();
  for (int j = warp; j < L; j += kThreads / 32)
    for (int d = lane; d < dh; d += 32) As[j * kBP + d] *= a_s[j];
  __syncthreads();

  const long long E = (long long)dh * dh + dh;
  float* W = work + (bh * NC + c) * E;
  for (int d0 = 0; d0 < dh; d0 += 64) {
    float acc[8][6];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[r][i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < L; ++j) fma_8x6(As + j * kBP + d0 + 8 * warp, Bs + j * kBP, lane, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int d = d0 + 8 * warp + r;
      if (d >= dh) continue;
      float* Wd = W + (long long)d * dh;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int p = 2 * lane + 64 * i;
        if (kVec) {
          if (p < dh) *reinterpret_cast<float2*>(Wd + p) = make_float2(acc[r][2 * i], acc[r][2 * i + 1]);
        } else {
          if (p < dh) Wd[p] = acc[r][2 * i];
          if (p + 1 < dh) Wd[p + 1] = acc[r][2 * i + 1];
        }
      }
    }
  }
  for (int d = tid; d < dh; d += kThreads) {
    float s = 0.f;
    for (int j = 0; j < L; ++j) s += As[j * kBP + d];
    W[(long long)dh * dh + d] = s;
  }
}

__device__ __forceinline__ float4 operator*(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}
__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}
__device__ __forceinline__ float fma4(float a, float x, float y) { return fmaf(a, x, y); }

// 2. The stabilizer chain, then C_in and n_in of every chunk in place.
// grid (ceil((dh * dh + dh) / (256 * width of V)), B * H); V is float4 where
// dh % 4 == 0 (C and n then split on a float4 boundary), else float.
template <typename V>
__global__ void __launch_bounds__(kThreads)
mlstm_prefix(float* __restrict__ work, const float2* __restrict__ sc,
             const float* __restrict__ C0, const float* __restrict__ n0,
             const float* __restrict__ m0, float* __restrict__ C1, float* __restrict__ n1,
             float* __restrict__ m1, float* __restrict__ m_in, int dh, int NC) {
  constexpr int kW = sizeof(V) / sizeof(float);
  __shared__ float2 f_s[kChain];      // (Lf_L, G) of a chunk, then (decay, scale)
  __shared__ float m_s;
  const long long bh = blockIdx.y;
  const long long CC = (long long)dh * dh, E = CC + dh;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * kW;
  const bool live = e < E;
  V run{};
  if (live) {
    if (e < CC) { if (C0 != nullptr) run = *reinterpret_cast<const V*>(C0 + bh * CC + e); }
    else if (n0 != nullptr) run = *reinterpret_cast<const V*>(n0 + bh * dh + (e - CC));
  }
  if (threadIdx.x == 0) m_s = m0 != nullptr ? m0[bh] : -30.f;
  V* w = reinterpret_cast<V*>(work + bh * NC * E + e);
  const long long stride = E / kW;    // a chunk's state, in V
  for (int c0 = 0; c0 < NC; c0 += kChain) {
    const int n = min(kChain, NC - c0);
    __syncthreads();                  // the previous window's factors are used
    for (int i = threadIdx.x; i < n; i += kThreads) f_s[i] = sc[bh * NC + c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = m_s;
      for (int i = 0; i < n; ++i) {
        const float LfL = f_s[i].x, G = f_s[i].y;
        const float uL = fmaxf(m, G);
        f_s[i] = make_float2(expf(m - uL), expf(G - uL));
        if (blockIdx.x == 0) m_in[bh * NC + c0 + i] = m;
        m = LfL + uL;
      }
      m_s = m;
    }
    __syncthreads();
    if (!live) continue;
    int i = 0;
    for (; i + 8 <= n; i += 8) {
      V x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = w[(c0 + i + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        w[(c0 + i + u) * stride] = run;
        run = fma4(f_s[i + u].y, x[u], f_s[i + u].x * run);
      }
    }
    for (; i < n; ++i) {
      const V x = w[(c0 + i) * stride];
      w[(c0 + i) * stride] = run;
      run = fma4(f_s[i].y, x, f_s[i].x * run);
    }
  }
  if (live) {
    if (e < CC) *reinterpret_cast<V*>(C1 + bh * CC + e) = run;
    else *reinterpret_cast<V*>(n1 + bh * dh + (e - CC)) = run;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) m1[bh] = m_s;
}

constexpr int kOutSmem =
    ((kMaxL + kMaxDh) * kAP + 2 * kKS * kBP + kMaxDh + 5 * kMaxL) * 4;

// 3. h of every chunk at once.  grid (chunks, B * H).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_out(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ ig,
          const float* __restrict__ lf, const float* __restrict__ work,
          const float* __restrict__ m_in, float* __restrict__ h, int S, int dh, int L) {
  extern __shared__ float4 smem4[];
  // AT rows 0..L-1: S^T [j][t]; rows L..L+dh-1: q^T [d][t], scaled by w_in_t
  // once the scores are done: the A operand of h = [S | w_in q] [v ; C_in]
  float* AT = reinterpret_cast<float*>(smem4);
  float* ring = AT + (kMaxL + kMaxDh) * kAP;     // [2][kKS][kBP], filled by cp.async
  float* n_s = ring + 2 * kKS * kBP;             // [dh] n_in
  float* g_s = n_s + kMaxDh;
  float* u_s = g_s + kMaxL;                      // u_t, after Lf_t
  float* win_s = u_s + kMaxL;                    // e^{m_in - u_t}
  float* fl_s = win_s + kMaxL;                   // e^{-(Lf_t + u_t)}
  float* den_s = fl_s + kMaxL;                   // max(|den_t|, floor_t)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, NC = gridDim.x;
  const long long bh = blockIdx.y;
  const long long row0 = bh * S + (long long)c * L;
  const float* qc = q + row0 * dh;
  const float* kc = k + row0 * dh;
  const float* vc = v + row0 * dh;
  const long long E = (long long)dh * dh + dh;
  const float* Cin = work + (bh * NC + c) * E;   // C_in [d][p], then n_in

  // k^T slice sl (rows d of 16, columns j) into ring stage sl & 1
  auto issue_k = [&](int sl) {
    float* B = ring + (sl & 1) * kKS * kBP;
#pragma unroll
    for (int i = 0; i < kKS * kMaxL / kThreads; ++i) {
      const int e = tid + kThreads * i, dd = e % kKS, j = e / kKS, d = sl * kKS + dd;
      const bool ok = j < L && d < dh;
      cp_async4(B + dd * kBP + j, ok ? kc + (long long)j * dh + d : kc, ok);
    }
    cp_commit();
  };
  issue_k(0);
  for (int e = tid; e < kMaxL * dh; e += kThreads) {
    const int t = e / dh, d = e % dh;
    AT[(L + d) * kAP + t] = t < L ? qc[(long long)t * dh + d] : 0.f;
  }
  for (int d = tid; d < dh; d += kThreads) n_s[d] = Cin[(long long)dh * dh + d];
  if (warp == 0) {
    chunk_gates(ig + row0, lf + row0, L, u_s, g_s, win_s);   // u_s <- Lf, win_s <- cm
    __syncwarp();
    const float mi = m_in[bh * NC + c];
    for (int t = lane; t < L; t += 32) {
      const float u = fmaxf(mi, win_s[t]);
      fl_s[t] = expf(-(u_s[t] + u));
      win_s[t] = expf(mi - u);
      u_s[t] = u;
    }
  }

  // ---- scores: S[t][j] for t = 8 warp + r, j = 2 lane + x, depth d --------
  float sacc[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) sacc[r][0] = sacc[r][1] = 0.f;
  const int nks = (dh + kKS - 1) / kKS;
  for (int sl = 0; sl < nks; ++sl) {
    cp_wait_all();
    __syncthreads();                          // slice sl is in; slice sl - 1 is used
    if (sl + 1 < nks) issue_k(sl + 1);
    const float* B = ring + (sl & 1) * kKS * kBP;
    const int kn = min(kKS, dh - sl * kKS);
    const float* A = AT + (L + sl * kKS) * kAP + 8 * warp;
    if (kn == kKS) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) fma_8x2(A + kk * kAP, B + kk * kBP, lane, sacc);
    } else {
      for (int kk = 0; kk < kn; ++kk) fma_8x2(A + kk * kAP, B + kk * kBP, lane, sacc);
    }
  }

  // ---- weights, S^T into AT, denominators --------------------------------
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = 8 * warp + r;
    float rs = 0.f;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = 2 * lane + x;
      const float w = (t < L && j <= t) ? sacc[r][x] * expf(g_s[j] - u_s[t]) : 0.f;
      rs += w;
      if (j < L) AT[j * kAP + t] = w;
    }
    rs = warp_sum(rs);
    float qn = 0.f;
    for (int d = lane; d < dh; d += 32) qn = fmaf(AT[(L + d) * kAP + t], n_s[d], qn);
    qn = warp_sum(qn);
    if (lane == 0 && t < L) den_s[t] = fmaxf(fabsf(rs + win_s[t] * qn), fl_s[t]);
  }
  __syncthreads();                            // q^T is read, S^T written, the ring free

  // ---- h = [S | w_in q] [v ; C_in]: t = 8 warp + r, p = 2 lane + 64 i + x --
  const int K = L + dh;
  const int nbs = (K + kKS - 1) / kKS;
  // rows [16 sl, 16 sl + 16) of [v ; C_in] into ring stage sl & 1
  auto issue_b = [&](int sl) {
    float* B = ring + (sl & 1) * kKS * kBP;
    if (kVec) {
      const int qd = dh / 4;
      for (int e = tid; e < kKS * qd; e += kThreads) {
        const int kk = e / qd, p = 4 * (e % qd), kr = sl * kKS + kk;
        const float* src = kr < L ? vc + (long long)kr * dh + p
                                  : Cin + (long long)(kr - L) * dh + p;
        cp_async16(B + kk * kBP + p, kr < K ? src : vc, kr < K);
      }
    } else {
      for (int e = tid; e < kKS * dh; e += kThreads) {
        const int kk = e / dh, p = e % dh, kr = sl * kKS + kk;
        const float* src = kr < L ? vc + (long long)kr * dh + p
                                  : Cin + (long long)(kr - L) * dh + p;
        cp_async4(B + kk * kBP + p, kr < K ? src : vc, kr < K);
      }
    }
    cp_commit();
  };
  issue_b(0);
  for (int e = tid; e < dh * kMaxL; e += kThreads) {
    const int d = e / kMaxL, t = e % kMaxL;
    AT[(L + d) * kAP + t] *= t < L ? win_s[t] : 0.f;
  }
  float acc[8][6];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[r][i] = 0.f;
  for (int sl = 0; sl < nbs; ++sl) {
    cp_wait_all();
    __syncthreads();                          // slice sl is in (and q^T scaled)
    if (sl + 1 < nbs) issue_b(sl + 1);
    const float* B = ring + (sl & 1) * kKS * kBP;
    const int kn = min(kKS, K - sl * kKS);
    const float* A = AT + (sl * kKS) * kAP + 8 * warp;
    if (kn == kKS) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) fma_8x6(A + kk * kAP, B + kk * kBP, lane, acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) fma_8x6(A + kk * kAP, B + kk * kBP, lane, acc);
    }
  }

  float* hc = h + row0 * dh;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = 8 * warp + r;
    if (t >= L) continue;
    const float den = den_s[t];
    float* ht = hc + (long long)t * dh;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int p = 2 * lane + 64 * i;
      if (kVec) {
        if (p < dh) *reinterpret_cast<float2*>(ht + p) =
            make_float2(acc[r][2 * i] / den, acc[r][2 * i + 1] / den);
      } else {
        if (p < dh) ht[p] = acc[r][2 * i] / den;
        if (p + 1 < dh) ht[p + 1] = acc[r][2 * i + 1] / den;
      }
    }
  }
}

template <bool kVec>
int launch(const float* q, const float* k, const float* v, const float* ig, const float* lf,
           const float* C0, const float* n0, const float* m0, float* h, float* C1, float* n1,
           float* m1, float* work, float2* sc, float* mi, long long BH, int NC, int S, int dh,
           int L, cudaStream_t s) {
  const long long E = (long long)dh * dh + dh;
  int err = (int)cudaFuncSetAttribute(mlstm_delta<kVec>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kDeltaSmem);
  if (!err)
    err = (int)cudaFuncSetAttribute(mlstm_out<kVec>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kOutSmem);
  if (err) return err;
  mlstm_delta<kVec><<<dim3(NC, (unsigned)BH), kThreads, kDeltaSmem, s>>>(k, v, ig, lf, work,
                                                                        sc, S, dh, L);
  err = (int)cudaGetLastError();
  if (err) return err;
  using V = typename std::conditional<kVec, float4, float>::type;
  const long long per_block = (long long)kThreads * (sizeof(V) / sizeof(float));
  mlstm_prefix<V><<<dim3((unsigned)((E + per_block - 1) / per_block), (unsigned)BH), kThreads,
                    0, s>>>(work, sc, C0, n0, m0, C1, n1, m1, mi, dh, NC);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm_out<kVec><<<dim3(NC, (unsigned)BH), kThreads, kOutSmem, s>>>(q, k, v, ig, lf, work,
                                                                    mi, h, S, dh, L);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, h [B, H, S, dh]; ig, lf [B, H, S]; C [B, H, dh, dh]; n [B, H, dh];
// m [B, H]; all float32 and contiguous.  S must be a multiple of L, with
// 1 <= L <= 64 and 1 <= dh <= 192.  C0, n0 and m0 may all be NULL: the zero
// state with m = -30.  C1, n1 and m1 receive the final state.  work is
// scratch of B * H * (S / L) * (dh * dh + dh + 3) floats.
extern "C" int mlstm_scan(const float* q, const float* k, const float* v, const float* ig,
                          const float* lf, const float* C0, const float* n0,
                          const float* m0, float* h, float* C1, float* n1, float* m1,
                          float* work, int B, int H, int S, int dh, int L, void* stream) {
  if (L < 1 || L > kMaxL || dh < 1 || dh > kMaxDh || S < 1 || S % L != 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int NC = S / L;
  const long long BH = (long long)B * H;
  if (NC > 2147483647 / kThreads || BH > 65535) return (int)cudaErrorInvalidValue;
  const long long E = (long long)dh * dh + dh;          // even: dh (dh + 1)
  float2* sc = reinterpret_cast<float2*>(work + BH * NC * E);   // (Lf_L, G) a chunk
  float* mi = work + BH * NC * (E + 2);                 // m_in a chunk
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)h |
                          (uintptr_t)work | (uintptr_t)C0 | (uintptr_t)n0 | (uintptr_t)C1 |
                          (uintptr_t)n1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh % 4 == 0 && align % 16 == 0)
    return launch<true>(q, k, v, ig, lf, C0, n0, m0, h, C1, n1, m1, work, sc, mi, BH, NC, S,
                        dh, L, s);
  return launch<false>(q, k, v, ig, lf, C0, n0, m0, h, C1, n1, m1, work, sc, mi, BH, NC, S, dh,
                       L, s);
}

// ---------------------------------------------------------------------------
// The VJP of the chunk body's cumulative max, u_t = max_{j<=t} g_j, as JAX
// takes it: lax.cummax differentiates through lax.associative_scan(lax.max),
// whose odd/even recursion combines adjacent steps (pairs, the scan of the
// pairs, then the even outputs), and lax.max gives each operand of a tie half
// the cotangent.  One thread takes one row of n <= kMaxL steps: it rebuilds
// the recursion's levels (e_l: the level's elements, o_l: its scan), sends
// the cotangent down the levels (the odd outputs and the even combines), and
// then up through the pairs.  Every cotangent is a sum of at most two
// products by 1, 1/2 or 0, each rounded once (no FMA), so the result equals
// the plain version's (autograd through the same recursion) bit for bit.
// ---------------------------------------------------------------------------

// the share of a max's cotangent that operand x gets against operand y
__device__ __forceinline__ float tie_share(float d, float x, float y) {
  return x > y ? d : (x == y ? __fmul_rn(d, 0.5f) : 0.0f);
}

__global__ void cummax_bwd_kernel(const float* __restrict__ g, const float* __restrict__ dy,
                                  float* __restrict__ dg, long long rows, int n) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  constexpr int kAll = 2 * kMaxL;   // every level of kMaxL steps: 64 + 32 + ... + 1
  float e[kAll], o[kAll], dout[kAll], de[kAll];
  int off[8], len[8];
  int depth = 0;
  off[0] = 0;
  len[0] = n;
  for (int t = 0; t < n; ++t) e[t] = g[r * n + t];
  while (len[depth] >= 2) {                         // e_{l+1}[i] = max(e_l[2i], e_l[2i+1])
    const int lo = off[depth], m = len[depth] / 2;
    off[depth + 1] = lo + len[depth];
    len[depth + 1] = m;
    for (int i = 0; i < m; ++i) e[off[depth + 1] + i] = fmaxf(e[lo + 2 * i], e[lo + 2 * i + 1]);
    ++depth;
  }
  // the scan of each level, deepest first: o_l[2k+1] = o_{l+1}[k], o_l[0] = e_l[0],
  // o_l[2k+2] = max(o_{l+1}[k], e_l[2k+2])
  o[off[depth]] = e[off[depth]];
  for (int l = depth - 1; l >= 0; --l) {
    const int lo = off[l], up = off[l + 1], nl = len[l];
    o[lo] = e[lo];
    for (int k = 0; 2 * k + 1 < nl; ++k) o[lo + 2 * k + 1] = o[up + k];
    for (int k = 0; 2 * k + 2 < nl; ++k) o[lo + 2 * k + 2] = fmaxf(o[up + k], e[lo + 2 * k + 2]);
  }
  // down: each level's cotangent to its elements (de) and to the scan below (dout)
  for (int t = 0; t < n; ++t) dout[t] = dy[r * n + t];
  for (int l = 0; l < depth; ++l) {
    const int lo = off[l], up = off[l + 1], nl = len[l];
    for (int t = 0; t < nl; ++t) de[lo + t] = 0.0f;
    de[lo] = dout[lo];
    for (int k = 0; 2 * k + 1 < nl; ++k) dout[up + k] = dout[lo + 2 * k + 1];
    for (int k = 0; 2 * k + 2 < nl; ++k) {
      const float d = dout[lo + 2 * k + 2], x = o[up + k], c = e[lo + 2 * k + 2];
      dout[up + k] = __fadd_rn(dout[up + k], tie_share(d, x, c));
      de[lo + 2 * k + 2] = tie_share(d, c, x);
    }
  }
  de[off[depth]] = dout[off[depth]];                // the deepest scan is its element
  // up: each pair's cotangent to its two operands
  for (int l = depth - 1; l >= 0; --l) {
    const int lo = off[l], up = off[l + 1];
    for (int i = 0; i < len[l + 1]; ++i) {
      const float d = de[up + i], a = e[lo + 2 * i], b = e[lo + 2 * i + 1];
      de[lo + 2 * i] = __fadd_rn(de[lo + 2 * i], tie_share(d, a, b));
      de[lo + 2 * i + 1] = tie_share(d, b, a);
    }
  }
  for (int t = 0; t < n; ++t) dg[r * n + t] = de[t];
}

extern "C" int mlstm_cummax_bwd(const float* g, const float* dy, float* dg, long long rows,
                                int n, void* stream) {
  if (n < 1 || n > kMaxL || rows < 1) return (int)cudaErrorInvalidValue;
  constexpr int kRowThreads = 128;
  const long long blocks = (rows + kRowThreads - 1) / kRowThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cummax_bwd_kernel<<<(unsigned)blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, dy, dg, rows, n);
  return (int)cudaGetLastError();
}
