// Flash attention forward (K5) for Hopper (sm_90a): causal, optional
// sliding window, GQA. Replaces repro/kernels/flash_attention.py
// flash_attention_fwd (_kernel). Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the Python wrapper (flash_attention.py)
// checks and allocates every tensor and raises on a nonzero return.
//
// Contract (repro/kernels/ref.py flash_attention_ref): q (B,Sq,H,hd),
// k (B,Sk,KV,hd), v (B,Sk,KV,hd_v), all contiguous, f32 or bf16, one dtype;
// o (B,Sq,H,hd_v) in that dtype. Scores s = (q*scale)·k in f32; query row i
// sits at key position i + (Sk - Sq) and sees key j when j <= i + (Sk - Sq)
// and, with a window, j > i + (Sk - Sq) - window. Masked scores are -1e30
// (not -inf); the softmax runs in f32 and the output is acc / max(l, 1e-30).
// Query head h reads KV head h / (H/KV); K and V are never replicated.
//
// Layout on the card: one thread block per (q tile of 64 rows, head, batch).
// The TPU kernel's sequential KV grid axis becomes a loop inside the block.
// Q (scaled, transposed), each 64-key K tile (transposed), then the same
// tile's V, and the probabilities P are staged in shared memory as f32
// (87,040 bytes, set through cudaFuncAttributeMaxDynamicSharedMemorySize;
// two blocks fit on an SM). The 256 threads form a 16 x 16 grid: thread
// (ty, tx) computes the 4 x 4 score patch of rows 4ty.. and keys 4tx.., and
// then the 4 x 8 output patch of the same rows, so the running max m, the
// denominator l and the accumulator stay in its registers; a row's max and
// sum are register shuffles over the 16 lanes that share ty.
//
// Skipped tiles: the block visits only the KV tiles that some row of its q
// tile can see (none wholly above the diagonal, none wholly before the
// window). A row that cannot yet see any key of a visited tile gets
// s = -1e30 everywhere there, so m stays -1e30 and p = exp(0) = 1 adds junk
// to l and acc; the row's first live tile then has corr = exp(-1e30 - m) = 0,
// which zeroes that junk, so each row's state effectively starts at its
// first live tile. That is the JAX kernel's own arithmetic, which visits
// every tile. A row always has a live key (the wrapper requires Sq <= Sk).
// Tails (Sq or Sk not a multiple of 64) are masked: Q and K/V rows past the
// end are staged as zeros and never stored.
//
// Bound: compute. Two chained f32 products of 2·hd flop per (row, key) pair
// each, against 4-byte loads of q, k, v read once: hundreds of flop per
// byte at hd = 128, far above the card's f32 ridge (~20 flop/byte). This
// first version runs them on the CUDA cores (f32 FMA; no TF32, no wgmma,
// no TMA), each shared-memory operand reused 4 or 8 times from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per thread block
constexpr int BK = 64;             // keys per KV tile
constexpr int HD_MAX = 128;        // largest hd and hd_v
constexpr int THREADS = 256;       // 16 x 16
constexpr int LD = BQ + 4;         // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;
// Qt [HD_MAX][LD] | Kt [HD_MAX][LD], reused as V [BK][HD_MAX] | Pt [BK][LD]
constexpr int SMEM_FLOATS = 2 * HD_MAX * LD + BK * LD;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);
static_assert(BK * HD_MAX <= HD_MAX * LD, "V tile must fit the K buffer");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even, as .to(bf16)
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t Sq,
                 int64_t Sk, int H, int KV, int hd, int hd_v, int64_t window,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // Qt[d][r] = q[r][d] * scale
  float* KVs = smem + HD_MAX * LD;    // Kt[d][c], later V[c][dv]
  float* Pt = smem + 2 * HD_MAX * LD; // Pt[c][r] = p[r][c]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t nq = (Sq + BQ - 1) / BQ;
  const int64_t r0 = (nq - 1 - (int64_t)blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t off = Sk - Sq;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    const int64_t i = r0 + r;
    Qt[d * LD + r] =
        i < Sq ? to_f32(q[((b * Sq + i) * H + h) * hd + d]) * scale : 0.f;
  }

  // the KV tiles some row of this q tile can see
  const int64_t r_last = (r0 + BQ < Sq ? r0 + BQ : Sq) - 1;
  const int64_t j_hi = r_last + off;             // <= Sk - 1
  int64_t j_lo = 0;
  if (window > 0) {
    j_lo = r0 + off - window + 1;
    if (j_lo < 0) j_lo = 0;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  }

  for (int64_t j0 = (j_lo / BK) * BK; j0 <= j_hi; j0 += BK) {
    __syncthreads();                 // last tile's reads of KVs / Pt done
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e - c * hd;
      const int64_t j = j0 + c;
      KVs[d * LD + c] =
          j < Sk ? to_f32(k[((b * Sk + j) * KV + kvh) * hd + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 kk =
          *reinterpret_cast<const float4*>(&KVs[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], kv[c], s[i][c]);
    }

    // mask, then the online softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = r0 + ty * 4 + i + off;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = j0 + tx * 4 + c;
        bool ok = j <= qpos && j < Sk;
        if (window > 0) ok = ok && j > qpos - window;
        if (!ok) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + c) * LD + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();                 // Kt reads done, Pt complete

    for (int e = tid; e < BK * hd_v; e += THREADS) {
      const int c = e / hd_v, dv = e - c * hd_v;
      const int64_t j = j0 + c;
      KVs[c * HD_MAX + dv] =
          j < Sk ? to_f32(v[((b * Sk + j) * KV + kvh) * hd_v + dv]) : 0.f;
    }
    __syncthreads();

    // acc += P V; columns 4tx.. and 64 + 4tx.. (those >= hd_v are junk,
    // never stored)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * LD + ty * 4]);
      const float4 v0 =
          *reinterpret_cast<const float4*>(&KVs[c * HD_MAX + tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&KVs[c * HD_MAX + 64 + tx * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(pv[i], vv[u], acc[i][u]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = r0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((b * Sq + row) * H + h) * hd_v;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = (u < 4 ? 0 : 64) + tx * 4 + (u & 3);
      if (col < hd_v) store(out + col, acc[i][u] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd,
           int64_t hd_v, int64_t window, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((Sq + BQ - 1) / BQ), (unsigned int)H,
                  (unsigned int)B);
  flash_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, (int)H, (int)KV,
      (int)hd, (int)hd_v, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked every shape:
// 1 <= hd, hd_v <= 128, KV divides H, 0 < Sq <= Sk, window >= 0.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t H, int64_t KV, int64_t hd, int64_t hd_v,
                        int64_t window, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > HD_MAX || hd_v < 1 || hd_v > HD_MAX || KV < 1 ||
      H % KV != 0 || Sq < 1 || Sq > Sk || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, hd_v, window,
                         scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, hd_v,
                                 window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
