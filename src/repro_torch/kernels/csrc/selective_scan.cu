// Mamba selective scan (K6) for Hopper (sm_90a). Replaces
// repro/kernels/selective_scan.py selective_scan_fwd (_kernel). Plain C
// entry point, loaded with ctypes by repro_torch/kernels/_build.py; the
// Python wrapper (selective_scan.py) checks and allocates every tensor and
// raises on a nonzero return.
//
// Contract (repro/models/mamba.py selective_scan_ref with h0 = None): xc
// (B,S,di) contiguous, f32 or bf16 (read as f32); dt (B,S,di), Bm, Cm
// (B,S,st), A (di,st) and D (di,) f32, contiguous. For each (b, channel d)
// and each t in order, from h = 0:
//   h[s] <- exp(dt_t A[d,s]) h[s] + (dt_t B_t[s]) x_t      (s < st)
//   y_t   = sum_s h[s] C_t[s] + D[d] x_t
// y (B,S,di) f32 and the final state h (B,di,st) f32 are written.
//
// Layout on the card. The TPU kernel gives a grid cell a (128 x st) slab of
// channels in VMEM and walks the sequence as a sequential grid dimension.
// Here the parallelism is the B * di independent channels (65,536 at the
// serving path's B 8, di 8192), each with st <= 16 states: one thread owns
// one (b, channel) for the whole sequence, its st states and its row of A
// in registers (a compile-time st, so the arrays stay in registers), and
// walks t. Nothing crosses threads but B_t and C_t, which every channel of
// a batch row shares: a 128-thread block stages them in shared memory a
// chunk of CH = 8 steps at a time, double-buffered, so the block syncs once
// per chunk; every thread reads them four at a time (LDS.128, one address
// for the whole warp). x_t and dt_t are the thread's own, loaded coalesced
// along di into a ring of CH registers a chunk ahead, through pointers
// stepped by di. A thread past the ragged edge of di recomputes the last
// channel and stores nothing, so no load carries a predicate; any S >= 1 is
// taken (every chunk runs unchecked while the next one is whole too, then
// at most two chunks check each step, uniformly across the block).
//
// Bound: bytes. xc and dt are read once and y written once (12 bytes per
// (b, t, channel) in f32), beside which B, C, A, D and h_final are small:
// at B 8, S 2048, di 8192, st 16, 1.62 GB, 0.48 ms at 3.35 TB/s. The work is
// B S di st = 2.15e9 state updates with one exp each; the SFU's 16 exps
// per SM per clock take 0.51 ms at 1.98 GHz, every exp going there.
// Copies of this source with one choice undone, timed in turns
// (tools/tc_variants.py --only K6; PERF.md section 6, an H100 SXM at
// 700 W), show what held the first version of this kernel, 1.5 ms: its
// issue rate. Time followed the SASS instructions per state update, 17.2
// then, 7.7 now (a state update: one product and MUFU.EX2 for the decay,
// two products for (dt_t B_t[s]) x_t, the FMA into h, the FMA into y_t,
// half an LDS.128). What each choice is worth, against this source at
// ~0.82 ms:
// - A's row prescaled by log2(e) once, the decay one ex2.approx.ftz:
//   expf of the unscaled product (range reduction, the SFU's ex2, a
//   scaling; the first version's arithmetic) costs +0.45 ms;
// - (dt_t B_t[s]) x_t in the plain version's order, so that its products
//   are the plain version's to the bit: dt_t x_t once a step saves one
//   product a state update (0.77 ms with chunks of 4) but moves every
//   term by an ulp, and in strong decay at the serving path's shape its
//   worst error reaches 0.996 of the 1e-5 tolerance (0.70 in this order);
// - B, C read with LDS.128: one float at a time costs +0.1 ms or more;
// - y_t summed in one chain: four partial sums cost +0.05 ms;
// - one thread a channel: two (the states split, y_t by a shuffle) cost
//   +0.14 ms, so latency is not what the extra warps would buy; nor what
//   two channels a thread (+0.1 ms) or each step's exps taken in the step
//   before (+0.13 ms) would hide;
// - CH = 8: 2, 4 and 16 steps a chunk cost +0.16, +0.02, +0.02 ms;
// - every exp on the SFU: a share of them on the FMA pipe (a degree-5
//   polynomial after a Cody-Waite split) costs +0.05 ms at one state in
//   16 and more the larger the share: the issue slots it needs are not
//   spare.
// What is left is no single unit at its rate: issue (7.7 instructions an
// update, 0.50 ms), the SFU (0.51 ms) and memory (0.48 ms) each run at
// about 60%; exps replaced by a constant take ~0.57 ms. The sums are
// taken in another order than the plain version's einsum, and h and y_t
// by fused multiply-adds: the tolerance is 1e-5, not bit equality. No
// tensor cores: the recurrence is elementwise per channel (A is diagonal
// per (channel, state)), and a chunked, time-parallel form would double
// the exps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;       // threads per block, one channel each
constexpr int CH = 8;              // steps per staged chunk
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^z on the SFU: one MUFU.EX2 (0 below 2^-126)
__device__ __forceinline__ float ex2_sfu(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

// four consecutive staged floats (16-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename TX, int ST>
__global__ void __launch_bounds__(THREADS, 4)
selective_scan_kernel(const TX* __restrict__ xc, const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ D, float* __restrict__ y,
                      float* __restrict__ hout, int S, int64_t di) {
  constexpr int NBC = 2 * CH * ST;                  // B and C of one chunk
  constexpr int PER = (NBC + THREADS - 1) / THREADS;
  static_assert(ST % 4 == 0, "states are read four at a time");
  __shared__ __align__(16) float bc[2][CH][2 * ST];  // [buf][step][B | C]

  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * THREADS + tid;
  // a thread past the ragged edge computes the last channel again and
  // writes nothing, so no load needs a predicate
  const bool store = c < di;
  const int64_t cl = store ? c : di - 1;
  const int64_t row = (int64_t)blockIdx.y * S;      // (b, 0) in steps

  float a2[ST], h[ST];                    // A's row times log2(e); state
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    a2[s] = A[cl * ST + s] * LOG2E;
    h[s] = 0.f;
  }
  const float dd = D[cl];

  // x_t and dt_t in a ring of CH slots: step i of a chunk takes slot i and
  // refills it with the step CH later, so every load has a chunk to land
  TX xr[CH];
  float dr[CH];
  const TX* xq = xc + row * di + cl;      // the next step to load
  const float* dq = dt + row * di + cl;
  float* yq = y + row * di + cl;          // the next step to store
  auto fetch = [&](int i, bool ok) {
    if (ok) {
      xr[i] = *xq;
      dr[i] = *dq;
    }
    xq += di;
    dq += di;
  };
  // B and C of the chunk at t0: loaded into registers at its start,
  // stored to shared memory at its end
  float bcr[PER];
  auto fetch_bc = [&](int t0, bool full) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = tid + j * THREADS;
      const int i = k / (2 * ST), r = k % (2 * ST);
      bcr[j] = 0.f;
      if (k < NBC && (full || t0 + i < S))
        bcr[j] = (r < ST ? Bm : Cm)[(row + t0 + i) * ST + r % ST];
    }
  };
  auto stage_bc = [&](int buf) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = tid + j * THREADS;
      if (k < NBC) bc[buf][k / (2 * ST)][k % (2 * ST)] = bcr[j];
    }
  };
  // step i of a chunk staged in `buf`: every state, then y_t
  auto step = [&](int buf, int i, bool refill) {
    const float x = to_f32(xr[i]), d = dr[i];
    fetch(i, refill);
    const float* Bt = bc[buf][i];
    const float* Ct = bc[buf][i] + ST;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < ST / 4; ++q) {
      const float4 b4 = ld4(Bt + 4 * q), c4 = ld4(Ct + 4 * q);
      const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = 4 * q + r;
        const float dA = ex2_sfu(d * a2[s]);
        h[s] = fmaf(dA, h[s], d * bq[r] * x);   // the plain version's order
        acc = fmaf(h[s], cq[r], acc);
      }
    }
    if (store) *yq = fmaf(x, dd, acc);
    yq += di;
  };

#pragma unroll
  for (int i = 0; i < CH; ++i) fetch(i, i < S);
  fetch_bc(0, CH <= S);
  stage_bc(0);
  __syncthreads();

  // while this chunk and the next are whole, nothing is checked; then at
  // most two chunks, each step checked (uniformly across the block)
  int buf = 0, t0 = 0;
  for (; t0 + 2 * CH <= S; t0 += CH, buf ^= 1) {
    fetch_bc(t0 + CH, true);
#pragma unroll
    for (int i = 0; i < CH; ++i) step(buf, i, true);
    stage_bc(buf ^ 1);
    __syncthreads();
  }
  for (; t0 < S; t0 += CH, buf ^= 1) {
    fetch_bc(t0 + CH, false);
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (t0 + i < S) step(buf, i, t0 + CH + i < S);
    stage_bc(buf ^ 1);
    __syncthreads();
  }

  if (store) {
    float* ho = hout + ((int64_t)blockIdx.y * di + c) * ST;
#pragma unroll
    for (int s = 0; s < ST; ++s) ho[s] = h[s];
  }
}

template <typename TX>
int launch_st(int64_t st, const void* xc, const void* dt, const void* Bm,
              const void* Cm, const void* A, const void* D, void* y, void* h,
              int64_t B, int64_t S, int64_t di, cudaStream_t stream) {
#define SS_LAUNCH(N)                                                       \
  selective_scan_kernel<TX, N>                                             \
      <<<dim3((unsigned int)((di + THREADS - 1) / THREADS),                \
              (unsigned int)B),                                            \
         THREADS, 0, stream>>>(                                            \
          static_cast<const TX*>(xc), static_cast<const float*>(dt),       \
          static_cast<const float*>(Bm), static_cast<const float*>(Cm),    \
          static_cast<const float*>(A), static_cast<const float*>(D),      \
          static_cast<float*>(y), static_cast<float*>(h), (int)S, di)
  if (st == 4)
    SS_LAUNCH(4);
  else if (st == 8)
    SS_LAUNCH(8);
  else if (st == 16)
    SS_LAUNCH(16);
  else
    return (int)cudaErrorInvalidValue;
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype (xc): 0 = float32, 1 = bfloat16. The wrapper has checked every
// shape: B, S, di >= 1, B <= 65535, S < 2^31 - 2 CH, di <= 2^28, st in
// {4, 8, 16}.
int selective_scan_fwd(const void* xc, const void* dt, const void* Bm,
                       const void* Cm, const void* A, const void* D, void* y,
                       void* h, int x_dtype, int64_t B, int64_t S,
                       int64_t di, int64_t st, cudaStream_t stream) {
  if (B < 1 || S < 1 || di < 1 || B > 65535 || S > INT32_MAX - 2 * CH ||
      di > (int64_t{1} << 28))
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return launch_st<float>(st, xc, dt, Bm, Cm, A, D, y, h, B, S, di,
                            stream);
  if (x_dtype == 1)
    return launch_st<__nv_bfloat16>(st, xc, dt, Bm, Cm, A, D, y, h, B, S,
                                    di, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
