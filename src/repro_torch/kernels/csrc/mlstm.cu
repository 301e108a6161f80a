// mLSTM forward (K7) for Hopper (sm_90a): the stabilized matrix-memory
// recurrence of xLSTM in its chunkwise-parallel form, the products on the
// tensor cores in 3xTF32 (tf32_mma.cuh). Replaces repro/kernels/mlstm.py
// mlstm_fwd (_kernel). Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the Python wrapper (mlstm.py) checks and
// allocates every tensor, the scratch included, and raises on a nonzero
// return.
//
// Contract (repro/models/xlstm.py mlstm_cell_ref with state=None): q, k, v
// (B,S,H,hd) contiguous, f32 or bf16, one dtype; ig, fg (B,S,H) raw gate
// pre-activations, f32 or bf16; h (B,S,H,hd) f32. For each (b, head) and
// each t in order, with q and k scaled by sc = hd^-1/4 (v is not):
//   lf_t = -logaddexp(0, -f_t); m_t = max(lf_t + m_{t-1}, i_t)
//   C_t = f'_t C_{t-1} + i'_t v_t k_t^T, n_t likewise with k_t,
//   f'_t = exp(lf_t + m_{t-1} - m_t), i'_t = exp(i_t - m_t)
//   h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))
// from C = 0, n = 0, m = -1e30 (the TPU kernel's start).
//
// Chunkwise form. Over a chunk of L = 128 steps from c, with F_t the sum of
// lf from c to t and m_c the stabilizer before the chunk, unrolling gives
// the weight of step s <= t in C_t, w(s,t) = exp((F_t - F_s) + (i_s - m_t))
// <= 1, and the carried state's factor a_t = exp(F_t + m_c - m_t):
//   h_t den_t = a_t C_c q_t + sum_s w(s,t) (k_s . q_t) v_s
//   n_t . q_t = a_t n_c . q_t + sum_s w(s,t) (k_s . q_t)
//   C_{c+L} = a_{c+L-1} C_c + sum_s w(s, c+L-1) v_s k_s^T.
// Every sum is a matrix product, so the work moves to the tensor cores.
// Four launches on the stream:
//   1. gates: one warp per (b, head) runs the scalar recurrence for m_t in
//      order, with the plain version's operations (this stepwise m, not one
//      re-derived from a cumulative sum, since exp(-m_t) floors the
//      denominator), and stores m_t, i_t and F_t (summed in double, rounded
//      once): (B,H,S) floats each.
//   2. states: one block per (b, head, 64 x 64 tile of C) walks the chunks
//      with one [64 x L] . [L x 64] product each (v weighted by w(s, end)
//      in the fragment loads) and writes C at every chunk start but the
//      first to a scratch, (S/L - 1) hd^2 floats per (b, head); the blocks
//      of the first row of tiles also carry n.
//   3. intra: one block per (b, head, chunk) forms G = (Q K^T) . W, the
//      causal L x L weighted scores, once for every tile of v (B H S L
//      floats), and the denominator den_t from its row sums and n_c . q_t.
//   4. outputs: one block per (b, head, chunk, 64 columns of v): H = a Q
//      C_c^T + G V over depth hd + L, divided by den_t.
// Passes 2-4 stage their tiles through a three-deep ring of cp.async copies
// (f32 inputs 16-byte aligned, hd a multiple of 4; others are loaded,
// widened and stored element by element), so the next tile's load overlaps
// this tile's products; hd is padded with zeros in shared memory and in
// the scratch, never in the inputs. Each depth-8 step's three TF32 products
// are summed apart and added to the f32 accumulators with round-to-nearest
// (tc::mma3_rn): accumulated in place over a depth of 1024, the tensor
// core's own sums miss the 2e-4 tolerance at the path's shape.
//
// Bound: operations. The chunkwise form needs at least 4 hd^2 B H S f32
// products (the state update and the read-out, as L tends to 0); at L = 128
// it does 4 hd^2 B H S + 4 L hd B H S. At B 8, S 2048, H 4, hd 1024 that is
// 2.75e11 flop at least, 1.67 ms at 165 TFLOP/s of 3xTF32 (0.32 ms for the
// bytes of q, k, v and h). The state scratch, 2.0 GB written and read at
// that shape, is the price of keeping C off the chip: one (b, head)'s C is
// 4 MB.

#include "tf32_mma.cuh"

namespace {

using tc::to_f32;

constexpr int L = 128;             // steps per chunk
constexpr int HD_MAX = 1024;
constexpr int TS = 64;             // state and output tile width
constexpr int BK = 32;             // depth of one staged tile
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int LDQ = BK + 4;        // depth-contiguous tiles: 4 mod 32
constexpr int LDV = TS + 8;        // row-contiguous tiles: 8 mod 32
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// 1. gates: one warp per (b, head); 32 steps' gates at a time are loaded
// and their log-sigmoids taken in parallel, then walked in order
template <typename G>
__global__ void __launch_bounds__(32)
gates_kernel(const G* __restrict__ ig, const G* __restrict__ fg,
             float* __restrict__ Fo, float* __restrict__ Mo,
             float* __restrict__ Io, int64_t S, int H) {
  const int lane = threadIdx.x;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh % H;
  float m = NEG;
  double F = 0.0;
  for (int64_t t0 = 0; t0 < S; t0 += 32) {
    const int64_t t = t0 + lane;
    const bool ok = t < S;
    const float f = ok ? to_f32(fg[(b * S + t) * H + h]) : 0.f;
    const float i = ok ? to_f32(ig[(b * S + t) * H + h]) : 0.f;
    const float lf = -(fmaxf(-f, 0.f) + log1pf(expf(-fabsf(f))));
    float my_m = 0.f;
    double my_F = 0.0;
    const int n = (int)(S - t0 < 32 ? S - t0 : 32);
    for (int j = 0; j < n; ++j) {
      const float lfj = __shfl_sync(FULL, lf, j);
      const float ij = __shfl_sync(FULL, i, j);
      if ((t0 + j) % L == 0) F = 0.0;
      F += (double)lfj;
      m = fmaxf(lfj + m, ij);
      if (lane == j) {
        my_m = m;
        my_F = F;
      }
    }
    if (ok) {
      Fo[bh * S + t] = (float)my_F;
      Mo[bh * S + t] = my_m;
      Io[bh * S + t] = i;
    }
  }
}

// A fragment whose depth element c is also multiplied by w[c]
__device__ __forceinline__ void load_a_w(const float* p, int rs, int ks,
                                         const float* w, int lane,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  tc::split(p[g * rs + t * ks] * w[t], hi[0], lo[0]);
  tc::split(p[(g + 8) * rs + t * ks] * w[t], hi[1], lo[1]);
  tc::split(p[g * rs + (t + 4) * ks] * w[t + 4], hi[2], lo[2]);
  tc::split(p[(g + 8) * rs + (t + 4) * ks] * w[t + 4], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// 2. boundary states: 4 warps, 2 x 2 of 32 x 32 over the 64 x 64 tile
constexpr int ST_THREADS = 128;
constexpr int SUBS = L / BK;       // staged tiles per chunk
constexpr int ST_SMEM = (STAGES * 2 * BK * LDV + 2 * L) * 4;

template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
states_kernel(const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ Fg, const float* __restrict__ Mg,
              const float* __restrict__ Ig, float* __restrict__ Cst,
              float* __restrict__ Nst, int64_t S, int H, int hd, int hdp,
              int nc, float sc, bool vec) {
  extern __shared__ __align__(16) float smem[];  // STAGES x (V, K), ws
  float* ws = smem + STAGES * 2 * BK * LDV;       // [2][L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt = hdp / TS;
  const int vt = (int)(blockIdx.x % (nt * nt)) / nt;
  const int kt = (int)(blockIdx.x % (nt * nt)) % nt;
  const int64_t bh = blockIdx.x / (nt * nt), b = bh / H, h = bh % H;
  const int64_t rs = (int64_t)H * hd;
  const T* kb = k + (b * S * H + h) * hd + kt * TS;
  const T* vb = v + (b * S * H + h) * hd + vt * TS;
  const float *Fb = Fg + bh * S, *Mb = Mg + bh * S, *Ib = Ig + bh * S;
  const int n_it = (nc - 1) * SUBS;
  const bool carry_n = vt == 0 && tid < TS;

  auto load = [&](int it) {
    const int64_t t0 = (int64_t)(it / SUBS) * L + (it % SUBS) * BK;
    float* s = smem + (it % STAGES) * 2 * BK * LDV;
    tc::stage(s, LDV, vb + t0 * rs, rs, BK, TS, BK, hd - vt * TS, vec, tid,
              ST_THREADS);
    tc::stage(s + BK * LDV, LDV, kb + t0 * rs, rs, BK, TS, BK, hd - kt * TS,
              vec, tid, ST_THREADS);
  };

  float acc[2][4][4] = {};
  float nacc = 0.f;
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_it) load(p);
    tc::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int j = it / SUBS, sub = it % SUBS;
    float a = 1.f;
    if (sub == 0) {    // the chunk's weights w(s, end) * sc and factor
      const int64_t c0 = (int64_t)j * L, te = c0 + L - 1;
      const float Fe = Fb[te], me = Mb[te];
      for (int s = tid; s < L; s += ST_THREADS)
        ws[(j & 1) * L + s] = expf((Fe - Fb[c0 + s]) + (Ib[c0 + s] - me)) * sc;
      a = expf(Fe + (j ? Mb[c0 - 1] : NEG) - me);
    }
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_it) load(it + STAGES - 1);
    tc::cp_async_commit();
    if (sub == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] *= a;
      nacc *= a;
    }
    const float* Vs = smem + (it % STAGES) * 2 * BK * LDV;
    const float* Ks = Vs + BK * LDV;
    const float* w = ws + (j & 1) * L + sub * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[4], al[4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        tc::load_b(Ks + kk * LDV + wn * 32 + ni * 8, 1, LDV, lane, bhi[ni],
                   blo[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        load_a_w(Vs + kk * LDV + wm * 32 + mi * 16, 1, LDV, w + kk, lane, ah,
                 al);
        tc::mma3_rn(acc[mi], ah, al, bhi, blo);
      }
    }
    if (carry_n) {
#pragma unroll 8
      for (int s = 0; s < BK; ++s) nacc = fmaf(w[s], Ks[s * LDV + tid], nacc);
    }
    if (sub == SUBS - 1) {   // C and n at the start of chunk j + 1
      float* out = Cst + ((bh * (nc - 1) + j) * hdp + vt * TS) * hdp + kt * TS;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int r = wm * 32 + mi * 16 + g, c = wn * 32 + ni * 8 + 2 * t4;
          *reinterpret_cast<float2*>(out + (int64_t)r * hdp + c) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(out + (int64_t)(r + 8) * hdp + c) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      if (carry_n) Nst[(bh * (nc - 1) + j) * hdp + kt * TS + tid] = nacc;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. intra-chunk scores: 8 warps, 2 x 4 of 64 x 32 over the L x L scores
// (the two warps wholly above the diagonal skip the products)
constexpr int IN_THREADS = 256;
constexpr int IN_STAGE = 2 * L * LDQ + BK;   // Q, K, n_c
constexpr int IN_SMEM = (STAGES * IN_STAGE + 3 * L + 4 * L) * 4;

template <typename T>
__global__ void __launch_bounds__(IN_THREADS)
intra_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const float* __restrict__ Fg, const float* __restrict__ Mg,
             const float* __restrict__ Ig, const float* __restrict__ Nst,
             float* __restrict__ Gs, float* __restrict__ Den, int64_t S,
             int H, int hd, int hdp, int nc, float sc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Fs = smem + STAGES * IN_STAGE;
  float* Ms = Fs + L;
  float* Is = Ms + L;
  float* part = Is + L;          // [4][L] row sums of each warp column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int j = (int)(blockIdx.x % nc);
  const int64_t bh = blockIdx.x / nc, b = bh / H, h = bh % H;
  const int64_t c0 = (int64_t)j * L;
  const int len = (int)(S - c0 < L ? S - c0 : L);
  const int64_t rs = (int64_t)H * hd;
  const T* qb = q + ((b * S + c0) * H + h) * hd;
  const T* kb = k + ((b * S + c0) * H + h) * hd;
  const float* nb = Nst + (bh * (nc - 1) + j - 1) * hdp;   // j >= 1
  const bool live = wn * 32 <= wm * 64 + 63;
  const int n_it = hdp / BK;

  for (int r = tid; r < L; r += IN_THREADS) {
    const bool ok = r < len;
    Fs[r] = ok ? Fg[bh * S + c0 + r] : 0.f;
    Ms[r] = ok ? Mg[bh * S + c0 + r] : 0.f;
    Is[r] = ok ? Ig[bh * S + c0 + r] : 0.f;
  }
  auto load = [&](int it) {
    const int d0 = it * BK;
    float* s = smem + (it % STAGES) * IN_STAGE;
    tc::stage(s, LDQ, qb + d0, rs, L, BK, len, hd - d0, vec, tid, IN_THREADS);
    tc::stage(s + L * LDQ, LDQ, kb + d0, rs, L, BK, len, hd - d0, vec, tid,
              IN_THREADS);
    if (j > 0 && tid < BK) s[2 * L * LDQ + tid] = nb[d0 + tid];
  };

  float acc[4][4][4] = {};
  float nq = 0.f;                // n_c . q_t (q unscaled), row tid
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_it) load(p);
    tc::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_it) load(it + STAGES - 1);
    tc::cp_async_commit();
    const float* Qs = smem + (it % STAGES) * IN_STAGE;
    const float* Ks = Qs + L * LDQ;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[4], al[4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::load_b(Ks + (wn * 32 + ni * 8) * LDQ + kk, LDQ, 1, lane,
                     bhi[ni], blo[ni]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          tc::load_a(Qs + (wm * 64 + mi * 16) * LDQ + kk, LDQ, 1, lane, ah,
                     al);
          tc::mma3_rn(acc[mi], ah, al, bhi, blo);
        }
      }
    }
    if (j > 0 && tid < L) {
      const float* ns = Ks + L * LDQ;
#pragma unroll 8
      for (int e = 0; e < BK; ++e) {
        const int d = (e + tid) & (BK - 1);     // no bank conflicts
        nq = fmaf(Qs[tid * LDQ + d], ns[d], nq);
      }
    }
  }

  // G = sc^2 (q . k) w(s, t) for s <= t < len, else 0; row sums per warp
  float* gout = Gs + (bh * nc + j) * (int64_t)L * L;
  const float sc2 = sc * sc;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + mi * 16 + g + 8 * hf;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = wn * 32 + ni * 8 + 2 * t4 + e;
          val[e] = 0.f;
          if (live && s <= r && r < len)
            val[e] = acc[mi][ni][2 * hf + e] * sc2 *
                     expf((Fs[r] - Fs[s]) + (Is[s] - Ms[r]));
          rsum[hf] += val[e];
        }
        *reinterpret_cast<float2*>(gout + r * L + wn * 32 + ni * 8 + 2 * t4) =
            make_float2(val[0], val[1]);
      }
      rsum[hf] += __shfl_xor_sync(FULL, rsum[hf], 1);
      rsum[hf] += __shfl_xor_sync(FULL, rsum[hf], 2);
      if (t4 == 0) part[wn * L + r] = rsum[hf];
    }
  }
  __syncthreads();
  if (tid < len) {
    const float rsum = part[tid] + part[L + tid] + part[2 * L + tid] +
                       part[3 * L + tid];
    float nqt = rsum;
    if (j > 0) {
      const float a = expf(Fs[tid] + Mg[bh * S + c0 - 1] - Ms[tid]);
      nqt = fmaf(a * sc, nq, rsum);
    }
    Den[bh * S + c0 + tid] = fmaxf(fabsf(nqt), expf(-Ms[tid]));
  }
}

// ---------------------------------------------------------------------------
// 4. outputs: 8 warps, 4 x 2 of 32 x 32 over L rows x 64 columns of v; the
// depth runs over hd (Q C_c^T, chunks after the first) then over L (G V)
constexpr int OUT_THREADS = 256;
constexpr int OUT_A = L * LDQ;                       // Q or G tile
constexpr int OUT_B = (TS * LDQ > BK * LDV ? TS * LDQ : BK * LDV);
constexpr int OUT_STAGE = OUT_A + OUT_B;
constexpr int OUT_SMEM = (STAGES * OUT_STAGE + 2 * L) * 4;

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS)
out_kernel(const T* __restrict__ q, const T* __restrict__ v,
           const float* __restrict__ Fg, const float* __restrict__ Mg,
           const float* __restrict__ Cst, const float* __restrict__ Gs,
           const float* __restrict__ Den, float* __restrict__ hout,
           int64_t S, int H, int hd, int hdp, int nc, float sc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* rowf = smem + STAGES * OUT_STAGE;   // a_t * sc
  float* den = rowf + L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt = hdp / TS;
  const int vt = (int)(blockIdx.x % nt);
  const int j = (int)((blockIdx.x / nt) % nc);
  const int64_t bh = blockIdx.x / ((int64_t)nt * nc), b = bh / H, h = bh % H;
  const int64_t c0 = (int64_t)j * L;
  const int len = (int)(S - c0 < L ? S - c0 : L);
  const int64_t rs = (int64_t)H * hd;
  const T* qb = q + ((b * S + c0) * H + h) * hd;
  const T* vb = v + ((b * S + c0) * H + h) * hd + vt * TS;
  const float* cb = Cst + ((bh * (nc - 1) + j - 1) * hdp + vt * TS) * hdp;
  const float* gb = Gs + (bh * nc + j) * (int64_t)L * L;
  const int n_qc = j > 0 ? hdp / BK : 0;
  const int n_it = n_qc + L / BK;

  for (int r = tid; r < L; r += OUT_THREADS) {
    const bool ok = r < len && j > 0;
    rowf[r] = ok ? expf(Fg[bh * S + c0 + r] + Mg[bh * S + c0 - 1] -
                        Mg[bh * S + c0 + r]) * sc
                 : 0.f;
    den[r] = r < len ? Den[bh * S + c0 + r] : 1.f;
  }
  auto load = [&](int it) {
    float* s = smem + (it % STAGES) * OUT_STAGE;
    if (it < n_qc) {
      const int d0 = it * BK;
      tc::stage(s, LDQ, qb + d0, rs, L, BK, len, hd - d0, vec, tid,
                OUT_THREADS);
      tc::stage(s + OUT_A, LDQ, cb + d0, (int64_t)hdp, TS, BK, TS, BK, true,
                tid, OUT_THREADS);
    } else {
      const int s0 = (it - n_qc) * BK;
      tc::stage(s, LDQ, gb + s0, (int64_t)L, L, BK, L, BK, true, tid,
                OUT_THREADS);
      tc::stage(s + OUT_A, LDV, vb + s0 * rs, rs, BK, TS, len - s0,
                hd - vt * TS, vec, tid, OUT_THREADS);
    }
  };

  float acc[2][4][4] = {};
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_it) load(p);
    tc::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_it) load(it + STAGES - 1);
    tc::cp_async_commit();
    const float* As = smem + (it % STAGES) * OUT_STAGE;
    const float* Bs = As + OUT_A;
    const bool gv = it >= n_qc;
    if (it == n_qc && j > 0) {       // a_t sc (C_c q_t), then add G V
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float f0 = rowf[wm * 32 + mi * 16 + g];
        const float f1 = rowf[wm * 32 + mi * 16 + g + 8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          acc[mi][ni][0] *= f0;
          acc[mi][ni][1] *= f0;
          acc[mi][ni][2] *= f1;
          acc[mi][ni][3] *= f1;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[4], al[4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n0 = wn * 32 + ni * 8;
        if (gv)
          tc::load_b(Bs + kk * LDV + n0, 1, LDV, lane, bhi[ni], blo[ni]);
        else
          tc::load_b(Bs + n0 * LDQ + kk, LDQ, 1, lane, bhi[ni], blo[ni]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        tc::load_a(As + (wm * 32 + mi * 16) * LDQ + kk, LDQ, 1, lane, ah, al);
        tc::mma3_rn(acc[mi], ah, al, bhi, blo);
      }
    }
  }

  const int cols = hd - vt * TS;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 32 + mi * 16 + g + 8 * hf;
      if (r >= len) continue;
      float* out = hout + ((b * S + c0 + r) * H + h) * hd + vt * TS;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * 32 + ni * 8 + 2 * t4 + e;
          if (c < cols) out[c] = acc[mi][ni][2 * hf + e] / den[r];
        }
    }
}

// ---------------------------------------------------------------------------
template <typename T, typename G>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, float* scratch, int64_t B, int64_t S,
           int64_t H, int64_t hd, float scale, cudaStream_t stream) {
  const int64_t BH = B * H, nc = ceil_div(S, L), hdp = ceil_div(hd, TS) * TS;
  const int64_t nt = hdp / TS;
  // scratch (floats), each part a multiple of 4: C at chunk starts 1..nc-1,
  // G, n at chunk starts, F, m, i, den
  float* Cst = scratch;
  float* Gs = Cst + BH * (nc - 1) * hdp * hdp;
  float* Nst = Gs + BH * nc * L * L;
  float* Fg = Nst + BH * (nc - 1) * hdp;
  float* Mg = Fg + BH * S;
  float* Ig = Mg + BH * S;
  float* Den = Ig + BH * S;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  const bool vec = sizeof(T) == 4 && hd % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(states_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ST_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(intra_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  IN_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(out_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  OUT_SMEM)) != cudaSuccess)
    return (int)err;
  gates_kernel<G><<<(unsigned)BH, 32, 0, stream>>>(
      static_cast<const G*>(ig), static_cast<const G*>(fg), Fg, Mg, Ig, S,
      (int)H);
  if (nc > 1)
    states_kernel<T><<<(unsigned)(BH * nt * nt), ST_THREADS, ST_SMEM,
                       stream>>>(
        kt, vt, Fg, Mg, Ig, Cst, Nst, S, (int)H, (int)hd, (int)hdp, (int)nc,
        scale, vec);
  intra_kernel<T><<<(unsigned)(BH * nc), IN_THREADS, IN_SMEM, stream>>>(
      qt, kt, Fg, Mg, Ig, Nst, Gs, Den, S, (int)H, (int)hd, (int)hdp,
      (int)nc, scale, vec);
  out_kernel<T><<<(unsigned)(BH * nc * nt), OUT_THREADS, OUT_SMEM, stream>>>(
      qt, vt, Fg, Mg, Cst, Gs, Den, static_cast<float*>(h), S, (int)H,
      (int)hd, (int)hdp, (int)nc, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gates(int gate_dtype, const void* q, const void* k, const void* v,
                 const void* ig, const void* fg, void* h, float* scratch,
                 int64_t B, int64_t S, int64_t H, int64_t hd, float scale,
                 cudaStream_t stream) {
  if (gate_dtype == 0)
    return launch<T, float>(q, k, v, ig, fg, h, scratch, B, S, H, hd, scale,
                            stream);
  if (gate_dtype == 1)
    return launch<T, __nv_bfloat16>(q, k, v, ig, fg, h, scratch, B, S, H,
                                    hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (q, k, v) and gate_dtype (ig, fg): 0 = float32, 1 = bfloat16. The
// wrapper has checked every shape (B, S, H >= 1, 1 <= hd <= 1024) and
// allocated ``scratch`` (f32, 16-byte aligned) with mlstm.scratch_floats.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* ig,
              const void* fg, void* h, void* scratch, int dtype,
              int gate_dtype, int64_t B, int64_t S, int64_t H, int64_t hd,
              float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > HD_MAX ||
      (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_gates<float>(gate_dtype, q, k, v, ig, fg, h, s, B, S, H,
                               hd, scale, stream);
  if (dtype == 1)
    return launch_gates<__nv_bfloat16>(gate_dtype, q, k, v, ig, fg, h, s, B,
                                       S, H, hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
