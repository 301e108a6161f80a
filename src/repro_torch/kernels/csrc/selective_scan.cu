// Mamba selective scan (K6) for Hopper (sm_90a). Replaces
// repro/kernels/selective_scan.py selective_scan_fwd (_kernel). Plain C
// entry point, loaded with ctypes by repro_torch/kernels/_build.py; the
// Python wrapper (selective_scan.py) checks and allocates every tensor and
// raises on a nonzero return.
//
// Contract (repro/models/mamba.py selective_scan_ref with h0 = None): xc
// (B,S,di) contiguous, f32 or bf16 (read as f32); dt (B,S,di), Bm, Cm
// (B,S,st), A (di,st) and D (di,) f32, contiguous. For each (b, channel d) and each t in order,
// from h = 0:
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
// walks t. (One thread per state instead would need a 16-lane shuffle sum
// for y_t every step, four shuffles and four adds per state update beside
// its one FMA; 65,536 threads, 15.5 warps an SM, each with st independent
// state chains, already give the scheduler work to interleave.) Nothing
// crosses threads but B_t and C_t, which every channel of a batch row
// shares: a 128-thread block stages them in shared memory a chunk of
// CH = 8 steps at a time, double-buffered, so the block syncs once per
// chunk. x_t and dt_t are the thread's own, loaded coalesced along di.
// The next chunk's x, dt, B and C are loaded into registers at the start of
// a chunk and converted / stored only at its end, so the loads overlap a
// whole chunk of work (as the mLSTM kernel does for its next step).
// Ragged di is masked per thread; any S >= 1 is taken (a partial last
// chunk is skipped step by step, uniformly across the block).
//
// Bound: bytes. xc and dt are read once and y written once (12 bytes per
// (b, t, channel) in f32), beside which B, C, A, D and h_final are small:
// at B 8, S 2048, di 8192, st 16, 1.62 GB, 0.48 ms at 3.35 TB/s. The work is
// B S di st = 2.15e9 state updates of 7 flop and one exp each (0.26 ms at
// 67 TFLOP/s counting the exp as one operation); the exps go to the SFU,
// 16 per SM per clock, about 0.6 ms, which is the likely floor of this
// design. expf (not __expf) keeps the plain version's 1e-5. No tensor cores:
// the recurrence is elementwise per channel (the chunked parallel form is
// later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int CH = 8;          // steps per staged chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX, int ST>
__global__ void __launch_bounds__(THREADS, 4)
selective_scan_kernel(const TX* __restrict__ xc, const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ D, float* __restrict__ y,
                      float* __restrict__ hout, int64_t S, int64_t di) {
  constexpr int NBC = 2 * CH * ST;                  // B and C of one chunk
  constexpr int PER = (NBC + THREADS - 1) / THREADS;
  __shared__ __align__(16) float bc[2][CH][2 * ST];  // [buf][step][B | C]

  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * THREADS + tid;
  const bool live = c < di;
  const int64_t b = blockIdx.y;
  const int64_t xbase = b * S * di + c;   // (b, 0, c) of xc, dt, y
  const int64_t sbase = b * S * ST;       // (b, 0, 0) of Bm, Cm

  float a[ST], h[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    a[s] = live ? A[c * ST + s] : 0.f;
    h[s] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;

  // the chunk being loaded (raw), and the chunk being computed (as f32)
  TX xr[CH];
  float dr[CH];
  float bcr[PER];
  float xf[CH], df[CH];

  // start the loads of the chunk at t0 (nothing waits on them here)
  auto load = [&](int64_t t0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int64_t t = t0 + i;
      if (live && t < S) {
        xr[i] = xc[xbase + t * di];
        dr[i] = dt[xbase + t * di];
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = tid + j * THREADS;
      bcr[j] = 0.f;
      if (k < NBC) {
        const int i = k / (2 * ST), r = k % (2 * ST);
        const int64_t t = t0 + i;
        if (t < S)
          bcr[j] = r < ST ? Bm[sbase + t * ST + r]
                          : Cm[sbase + t * ST + (r - ST)];
      }
    }
  };
  // convert the loaded chunk for computing and stage its B, C in `buf`
  auto stage = [&](int64_t t0, int buf) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool ok = live && t0 + i < S;
      xf[i] = ok ? to_f32(xr[i]) : 0.f;
      df[i] = ok ? dr[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = tid + j * THREADS;
      if (k < NBC) bc[buf][k / (2 * ST)][k % (2 * ST)] = bcr[j];
    }
  };

  load(0);
  stage(0, 0);
  __syncthreads();

  int buf = 0;
  for (int64_t t0 = 0; t0 < S; t0 += CH, buf ^= 1) {
    const bool more = t0 + CH < S;
    if (more) load(t0 + CH);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int64_t t = t0 + i;
      if (t < S) {
        const float x = xf[i], d = df[i];
        const float* Bt = bc[buf][i];
        const float* Ct = Bt + ST;
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float dA = expf(d * a[s]);
          h[s] = fmaf(dA, h[s], d * Bt[s] * x);
          acc = fmaf(h[s], Ct[s], acc);
        }
        if (live) y[xbase + t * di] = acc + x * dd;
      }
    }
    if (more) stage(t0 + CH, buf ^ 1);
    __syncthreads();
  }

  if (live) {
    float* ho = hout + (b * di + c) * ST;
#pragma unroll
    for (int s = 0; s < ST; ++s) ho[s] = h[s];
  }
}

template <typename TX>
int launch_st(int64_t st, const void* xc, const void* dt, const void* Bm,
              const void* Cm, const void* A, const void* D, void* y, void* h,
              int64_t B, int64_t S, int64_t di, cudaStream_t stream) {
  const dim3 grid((unsigned int)((di + THREADS - 1) / THREADS),
                  (unsigned int)B);
#define SS_LAUNCH(N)                                                       \
  selective_scan_kernel<TX, N><<<grid, THREADS, 0, stream>>>(              \
      static_cast<const TX*>(xc), static_cast<const float*>(dt),           \
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),        \
      static_cast<const float*>(A), static_cast<const float*>(D),          \
      static_cast<float*>(y), static_cast<float*>(h), S, di)
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

// x_dtype (xc): 0 = float32, 1 = bfloat16. The wrapper
// has checked every shape: B, S, di >= 1, B <= 65535, st in {4, 8, 16}.
int selective_scan_fwd(const void* xc, const void* dt, const void* Bm,
                       const void* Cm, const void* A, const void* D, void* y,
                       void* h, int x_dtype, int64_t B, int64_t S,
                       int64_t di, int64_t st, cudaStream_t stream) {
  if (B < 1 || S < 1 || di < 1 || B > 65535 ||
      (di + THREADS - 1) / THREADS > 0x7fffffff)
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
