// mLSTM forward (K7) for Hopper (sm_90a): the stabilized matrix-memory
// recurrence of xLSTM. Replaces repro/kernels/mlstm.py mlstm_fwd (_kernel).
// Plain C entry point, loaded with ctypes by repro_torch/kernels/_build.py;
// the Python wrapper (mlstm.py) checks and allocates every tensor and raises
// on a nonzero return.
//
// Contract (repro/models/xlstm.py mlstm_cell_ref with state=None): q, k, v
// (B,S,H,hd) contiguous, f32 or bf16, one dtype; ig, fg (B,S,H) raw gate
// pre-activations, f32 or bf16; h (B,S,H,hd) f32. For each (b, head) and
// each t in order, with q and k scaled by hd^-1/4 (v is not):
//   logf = -logaddexp(0, -f_t); m' = max(logf + m, i_t)
//   f' = exp(logf + m - m'), i' = exp(i_t - m')
//   C <- f' C + i' v_t k_t^T (hd x hd), n <- f' n + i' k_t
//   h_t = C q_t / max(|n . q_t|, exp(-m'))
// starting from C = 0, n = 0, m = -1e30 (the TPU kernel's start).
//
// Layout on the card. The TPU kernel keeps one (b, head)'s whole C (4 MB at
// hd = 1024) in VMEM; an SM has 256 KB of registers and 228 KB of shared
// memory, and at B = 8, H = 4 the 32 matrices take 134 MB, more than the
// whole chip holds. But the rows of C (the v index) evolve independently
// given the scalar gates, so one thread block owns a slab of R = 32 rows of
// one (b, head) for the whole sequence, in registers: warp w holds rows
// 4w .. 4w + 3 and lane l columns 128 j + 4 l .. 128 j + 4 l + 3 (j < 8)
// of them (128 values a thread, read with 16-byte loads). No block waits on another; the B*H*hd/32 blocks run in
// waves, one block of 256 threads per SM. Each block recomputes the scalar
// gates (every thread the same numbers) and its own copy of n, spread as 4
// columns a thread: O(hd) per step against O(32 hd) for its slab. Per step
// the block stages q_t and k_t (scaled) and the slab's 32 values of v_t in
// shared memory, double-buffered: they are loaded at the start of step
// t - 1 and converted and stored at its end, so the loads overlap a whole
// step and the step has one __syncthreads. A thread updates its 128 values of C and sums its
// part of C q_t for its warp's 4 rows; a warp reduction gives each row's
// C q_t, so the read-out needs no other warp. Only n . q_t crosses warps,
// through shared memory behind the same barrier; then each warp divides
// and stores its 4 outputs.
//
// Bound: operations. Per step and element of C, a multiply (i'v_r * k_c)
// and two FMAs (the update and C q): 5 flop, 5 hd^2 B H S in all, against
// q, k, v read once and h written once (16 bytes per (b, t, head, index)).
// At B 8, S 2048, H 4, hd 1024: 3.44e11 flop (5.1 ms at 67 TFLOP/s f32)
// against 1.07 GB (0.32 ms at 3.35 TB/s). The slabs re-read q_t and k_t:
// (hd / 32) * B S H hd * 8 bytes of L2 traffic, 17 GB at that shape. No
// tensor cores: the recurrence is a rank-1 update and a matrix-vector
// product per step (wgmma, TMA and the chunkwise-parallel form are later
// work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RW = 4;              // rows of C per warp
constexpr int R = NWARPS * RW;     // rows of C per block
constexpr int HD_MAX = 1024;
constexpr int CPL = HD_MAX / 32;   // columns of C per lane
constexpr int NPT = HD_MAX / THREADS;  // columns of n per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <typename T, typename G>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const G* __restrict__ ig,
                 const G* __restrict__ fg, float* __restrict__ h, int64_t S,
                 int H, int hd, float scale) {
  __shared__ __align__(16) float qs[2][HD_MAX];   // q_t * scale
  __shared__ __align__(16) float ks[2][HD_MAX];   // k_t * scale
  __shared__ float vs[2][R];                      // the slab's v_t
  __shared__ float rnq[2][NWARPS];                // per-warp n . q_t

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * R;
  const int64_t b = blockIdx.z;
  const int64_t step = (int64_t)H * hd;   // (b, t, head, .) -> t + 1
  const int64_t base = (b * S * H + blockIdx.y) * (int64_t)hd;
  const int64_t gbase = b * S * H + blockIdx.y;

  float C[RW][CPL];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) C[i][j] = 0.f;
  // this thread's columns of n (tid + 256 jj) and of q_t, k_t for them
  float n[NPT], qn[NPT], kn[NPT];
  float m = -1e30f;
  // the next step's inputs as loaded, converted and scaled only when they
  // are staged at the end of the step: a conversion right after the load
  // would wait for it there
  T qr[NPT], kr[NPT], vr;
  G ir = ig[gbase], fr = fg[gbase];

  // step 0's inputs; later steps' are fetched one step ahead
#pragma unroll
  for (int jj = 0; jj < NPT; ++jj) {
    const int c = tid + jj * THREADS;
    n[jj] = 0.f;
    if (c < hd) {
      qr[jj] = q[base + c];
      kr[jj] = k[base + c];
    }
    qn[jj] = c < hd ? to_f32(qr[jj]) * scale : 0.f;
    kn[jj] = c < hd ? to_f32(kr[jj]) * scale : 0.f;
    qs[0][c] = qn[jj];
    ks[0][c] = kn[jj];
  }
  const bool has_v = tid < R && r0 + tid < hd;   // stages a row of v
  if (has_v) vr = v[base + r0 + tid];
  if (tid < R) vs[0][tid] = has_v ? to_f32(vr) : 0.f;
  float in_ = to_f32(ir), fn_ = to_f32(fr);
  __syncthreads();

  for (int64_t t = 0; t < S; ++t) {
    const int buf = (int)(t & 1);
    float qc[NPT], kc[NPT];
#pragma unroll
    for (int jj = 0; jj < NPT; ++jj) {
      qc[jj] = qn[jj];
      kc[jj] = kn[jj];
    }
    const float i_t = in_, f_t = fn_;
    if (t + 1 < S) {
      const int64_t off = base + (t + 1) * step;
#pragma unroll
      for (int jj = 0; jj < NPT; ++jj) {
        const int c = tid + jj * THREADS;
        if (c < hd) {
          qr[jj] = q[off + c];
          kr[jj] = k[off + c];
        }
      }
      ir = ig[gbase + (t + 1) * H];
      fr = fg[gbase + (t + 1) * H];
      if (has_v) vr = v[off + r0 + tid];
    }

    // the scalar gates (every thread computes the same numbers)
    const float lf = -(fmaxf(-f_t, 0.f) + log1pf(expf(-fabsf(f_t))));
    const float m_new = fmaxf(lf + m, i_t);
    const float fp = expf(lf + m - m_new);
    const float ip = expf(i_t - m_new);
    m = m_new;

    float nq = 0.f;
#pragma unroll
    for (int jj = 0; jj < NPT; ++jj) {
      n[jj] = fmaf(fp, n[jj], ip * kc[jj]);
      nq = fmaf(n[jj], qc[jj], nq);
    }
    nq = warp_sum(nq);
    if (lane == 0) rnq[buf][warp] = nq;

    float iv[RW], acc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      iv[i] = ip * vs[buf][warp * RW + i];
      acc[i] = 0.f;
    }
#pragma unroll
    for (int jb = 0; jb < CPL / 4; ++jb) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(&qs[buf][128 * jb + 4 * lane]);
      const float4 k4 =
          *reinterpret_cast<const float4*>(&ks[buf][128 * jb + 4 * lane]);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          float& c = C[i][4 * jb + u];
          c = fmaf(fp, c, iv[i] * kv[u]);
          acc[i] = fmaf(c, qv[u], acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) acc[i] = warp_sum(acc[i]);

    // stage step t + 1 in the other buffers (read in the next iteration;
    // after the last step this re-stages stale values that nothing reads)
#pragma unroll
    for (int jj = 0; jj < NPT; ++jj) {
      const int c = tid + jj * THREADS;
      qn[jj] = c < hd ? to_f32(qr[jj]) * scale : 0.f;
      kn[jj] = c < hd ? to_f32(kr[jj]) * scale : 0.f;
      qs[buf ^ 1][c] = qn[jj];
      ks[buf ^ 1][c] = kn[jj];
    }
    if (tid < R) vs[buf ^ 1][tid] = has_v ? to_f32(vr) : 0.f;
    in_ = to_f32(ir);
    fn_ = to_f32(fr);
    __syncthreads();

    float nqs = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) nqs += rnq[buf][w];
    const float den = fmaxf(fabsf(nqs), expf(-m_new));
    const int64_t out = base + t * step + r0 + warp * RW;
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (lane == i && r0 + warp * RW + i < hd) h[out + i] = acc[i] / den;
  }
}

template <typename T, typename G>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, int64_t B, int64_t S, int64_t H,
           int64_t hd, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned int)((hd + R - 1) / R), (unsigned int)H,
                  (unsigned int)B);
  mlstm_fwd_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const G*>(ig),
      static_cast<const G*>(fg), static_cast<float*>(h), S, (int)H, (int)hd,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gates(int gate_dtype, const void* q, const void* k, const void* v,
                 const void* ig, const void* fg, void* h, int64_t B,
                 int64_t S, int64_t H, int64_t hd, float scale,
                 cudaStream_t stream) {
  if (gate_dtype == 0)
    return launch<T, float>(q, k, v, ig, fg, h, B, S, H, hd, scale, stream);
  if (gate_dtype == 1)
    return launch<T, __nv_bfloat16>(q, k, v, ig, fg, h, B, S, H, hd, scale,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (q, k, v) and gate_dtype (ig, fg): 0 = float32, 1 = bfloat16. The
// wrapper has checked every shape: B, S, H >= 1, 1 <= hd <= 1024, B and H
// at most 65535.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* ig,
              const void* fg, void* h, int dtype, int gate_dtype, int64_t B,
              int64_t S, int64_t H, int64_t hd, float scale,
              cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > HD_MAX || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_gates<float>(gate_dtype, q, k, v, ig, fg, h, B, S, H, hd,
                               scale, stream);
  if (dtype == 1)
    return launch_gates<__nv_bfloat16>(gate_dtype, q, k, v, ig, fg, h, B, S,
                                       H, hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
