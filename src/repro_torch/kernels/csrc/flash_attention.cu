// Flash attention forward (K5) for Hopper (sm_90a): causal, optional
// sliding window, GQA, with both products on the tensor cores in 3xTF32
// (tf32_mma.cuh). Replaces repro/kernels/flash_attention.py
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
// Layout on the card. One block of 8 warps serves 128 query rows of one KV
// head: the Gb = min(H/KV, 8) query heads of a GQA group that share it, at
// P = 128 / Gb positions each (row r is position r / Gb, head r % Gb), so
// every staged K/V tile serves all of them (more than 8 heads a group take
// several blocks). The TPU kernel's sequential KV grid axis becomes a loop
// inside the block over 64-key tiles, longest rows first. Q (scaled once in
// shared memory, as the plain version scales it) stays in shared memory;
// K and V tiles arrive by cp.async into a two-deep ring, the next tile's
// copy overlapping this tile's products, in their natural row-major layout:
// K rows are the depth-contiguous B operand of S = Q K^T and V rows the
// row-contiguous B operand of O += P V (row strides 132 and 136 floats,
// read without bank conflicts). Each warp owns 16 rows: its scores, running
// max m, denominator l and output stay in registers (mma.sync m16n8k8
// fragments); P goes from the score fragments to the A fragments of P V by
// register shuffles, not through shared memory. f32 inputs 16-byte aligned
// with hd and hd_v multiples of 4 are copied with cp.async; others (bf16,
// ragged heads) are loaded, widened to f32 and stored element by element.
// Depth tails (hd, hd_v not multiples of 8) are zero-padded in shared memory.
//
// Skipped tiles: the block visits only the KV tiles that some row of it can
// see, and a warp skips the products of a tile that none of its 16 rows
// can see. A row that cannot yet see any key of a tile it computes gets
// s = -1e30 everywhere there, so m stays -1e30 and p = exp(0) = 1 adds junk
// to l and acc; the row's first live tile then has corr = exp(-1e30 - m) =
// 0, which zeroes that junk, so each row's state effectively starts at its
// first live tile (the JAX kernel's own arithmetic, which visits every
// tile). A row always has a live key (the wrapper requires Sq <= Sk).
//
// Bound: operations. Two chained products of 2 hd flop per visible (row,
// key) pair each (2 (hd + hd_v) in all) against q, k, v read once and o
// written once: hundreds of flop per byte at hd = 128. In 3xTF32 on the
// tensor cores that is 1.375e11 flop at internlm2-1.8b's prefill shape
// (B 8, S 2048, H 16, hd 128), 0.83 ms at 165 TFLOP/s.

#include "tf32_mma.cuh"

namespace {

using tc::to_f32;

constexpr int BQ = 128;            // query rows per block (8 warps x 16)
constexpr int BKV = 64;            // keys per KV tile
constexpr int HD_MAX = 128;        // largest hd and hd_v
constexpr int THREADS = 256;
constexpr int GB_MAX = 8;          // query heads of a GQA group per block
constexpr int LDK = HD_MAX + 4;    // Q, K rows (depth contiguous): 4 mod 32
constexpr int LDV = HD_MAX + 8;    // V rows (columns contiguous): 8 mod 32
constexpr int KV_STAGE = BKV * LDK + BKV * LDV;
constexpr int SMEM_BYTES = (BQ * LDK + 2 * KV_STAGE) * (int)sizeof(float);
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);        // round to nearest even, as .to(bf16)
}

// FULL: hd = hd_v = 128 (the serving paths' heads), every loop bound known
// at compile time so the depth loops unroll and their loads interleave
template <typename T, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t Sq,
                 int64_t Sk, int H, int KV, int hd, int hd_v, int64_t window,
                 float scale, int Gb, int ngrp, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [BQ][LDK]
  float* KVs = smem + BQ * LDK;                   // 2 x (K [BKV][LDK], V)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = H / KV, P = BQ / Gb;
  const int64_t nq = (Sq + P - 1) / P;
  const int64_t p0 = (nq - 1 - (int64_t)blockIdx.x) * P;   // longest first
  const int kvh = blockIdx.y / ngrp, gi = blockIdx.y % ngrp;
  const int h0 = kvh * G + gi * Gb;               // first query head
  const int nh = G - gi * Gb < Gb ? G - gi * Gb : Gb;
  const int64_t b = blockIdx.z;
  const int64_t off = Sk - Sq;
  const int kd = FULL ? HD_MAX : (hd + 7) & ~7;
  const int vd = FULL ? HD_MAX : (hd_v + 7) & ~7;

  // row r of the block: position p0 + r / Gb of head h0 + r % Gb
  auto row_ok = [&](int r) {
    return r < P * Gb && p0 + r / Gb < Sq && r % Gb < nh;
  };

  // Q: each row its own head's vector (stride H hd between positions)
  {
    const int c4 = kd / 4;
    for (int e = tid; e < BQ * c4; e += THREADS) {
      const int r = e / c4, c = (e - r * c4) * 4;
      const T* src = q + ((b * Sq + p0 + r / Gb) * H + h0 + r % Gb) * hd + c;
      float* dst = Qs + r * LDK + c;
      const bool ok = row_ok(r);
      if (sizeof(T) == 4 && vec) {
        tc::cp_async16(dst, ok && c < hd ? (const void*)src : (const void*)q,
                       ok && c < hd);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = ok && c + u < hd ? to_f32(src[u]) : 0.f;
      }
    }
  }

  // the KV tiles some row of this block can see; the rows of this warp
  const int64_t r_last = (p0 + P < Sq ? p0 + P : Sq) - 1;
  const int64_t j_hi = r_last + off;              // <= Sk - 1
  int64_t j_lo = 0;
  if (window > 0) {
    j_lo = p0 + off - window + 1;
    if (j_lo < 0) j_lo = 0;
  }
  const int64_t j_start = (j_lo / BKV) * BKV;
  const int n_tiles = (int)((j_hi - j_start) / BKV + 1);
  int64_t wmin = INT64_MAX, wmax = -1;
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    if (row_ok(r)) {
      const int64_t qp = p0 + r / Gb + off;
      wmin = qp < wmin ? qp : wmin;
      wmax = qp > wmax ? qp : wmax;
    }
  }
  int64_t qpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) qpos[hf] = p0 + (warp * 16 + g + 8 * hf) / Gb + off;

  auto load_kv = [&](int it) {
    const int64_t j0 = j_start + (int64_t)it * BKV;
    float* Ks = KVs + (it & 1) * KV_STAGE;
    const int rows_ok = (int)(Sk - j0 < BKV ? Sk - j0 : BKV);
    tc::stage(Ks, LDK, k + ((b * Sk + j0) * KV + kvh) * hd, (int64_t)KV * hd,
              BKV, kd, rows_ok, hd, vec, tid, THREADS);
    tc::stage(Ks + BKV * LDK, LDV, v + ((b * Sk + j0) * KV + kvh) * hd_v,
              (int64_t)KV * hd_v, BKV, vd, rows_ok, hd_v, vec, tid, THREADS);
  };

  load_kv(0);
  tc::cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float oacc[HD_MAX / 8][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();             // tile it landed; tile it - 1 is read
    if (it == 0) {               // q * scale, as the plain version rounds it
      for (int e = tid; e < BQ * kd; e += THREADS) {
        const int r = e / kd, c = e - r * kd;
        Qs[r * LDK + c] *= scale;
      }
      __syncthreads();
    }
    if (it + 1 < n_tiles) load_kv(it + 1);
    tc::cp_async_commit();

    const int64_t j0 = j_start + (int64_t)it * BKV;
    if (wmax < j0 || (window > 0 && j0 + BKV - 1 <= wmin - window)) continue;
    const float* Ks = KVs + (it & 1) * KV_STAGE;
    const float* Vs = Ks + BKV * LDK;

    // S = (q scale) K^T for this warp's 16 rows and the tile's 64 keys
    float s[BKV / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kd; kk += 8) {
      uint32_t ah[4], al[4], bh[BKV / 8][2], bl[BKV / 8][2];
      tc::load_a(Qs + warp * 16 * LDK + kk, LDK, 1, lane, ah, al);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
        tc::load_b(Ks + ni * 8 * LDK + kk, LDK, 1, lane, bh[ni], bl[ni]);
      tc::mma3(s, ah, al, bh, bl);
    }

    // mask, then the online softmax update of this lane's two rows
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = NEG_INF;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t j = j0 + ni * 8 + 2 * t4 + e;
          bool ok = j <= qpos[hf] && j < Sk;
          if (window > 0) ok = ok && j > qpos[hf] - window;
          float& x = s[ni][2 * hf + e];
          if (!ok) x = NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float corr = expf(m[hf] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[ni][2 * hf + e];
          x = expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      l[hf] = l[hf] * corr + rs;
      m[hf] = m_new;
#pragma unroll
      for (int ni = 0; ni < HD_MAX / 8; ++ni) {
        oacc[ni][2 * hf] *= corr;
        oacc[ni][2 * hf + 1] *= corr;
      }
    }

    // O += P V: P's A fragment of keys 8kc.. from the score fragment of the
    // same keys (lane (g, t) wants columns t and t + 4 of rows g, g + 8;
    // lane (g, c / 2) holds column c)
    const int src0 = (lane & ~3) | (t4 >> 1), src1 = src0 + 2;
    const bool odd = t4 & 1;
#pragma unroll
    for (int kc = 0; kc < BKV / 8; ++kc) {
      float pa[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {          // a0 a1 a2 a3
        const int src = u < 2 ? src0 : src1, base = (u & 1) * 2;
        const float x0 = __shfl_sync(FULL, s[kc][base], src);
        const float x1 = __shfl_sync(FULL, s[kc][base + 1], src);
        pa[u] = odd ? x1 : x0;
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) tc::split(pa[u], ah[u], al[u]);
      // four column tiles of V at a time (columns past hd_v are junk,
      // never stored)
#pragma unroll
      for (int n4 = 0; n4 < HD_MAX / 32; ++n4) {
        if (n4 * 32 < vd) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            tc::load_b(Vs + kc * 8 * LDV + (n4 * 4 + ni) * 8, 1, LDV, lane,
                       bh[ni], bl[ni]);
          tc::mma3(*reinterpret_cast<float(*)[4][4]>(oacc[n4 * 4]), ah, al,
                   bh, bl);
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * 16 + g + 8 * hf;
    if (!row_ok(r)) continue;
    const float denom = fmaxf(l[hf], 1e-30f);
    T* out = o + ((b * Sq + p0 + r / Gb) * H + h0 + r % Gb) * hd_v;
#pragma unroll
    for (int ni = 0; ni < HD_MAX / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ni * 8 + 2 * t4 + e;
        if (col < hd_v) store(out + col, oacc[ni][2 * hf + e] / denom);
      }
  }
}

template <typename T, bool FULL>
int run(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd,
           int64_t hd_v, int64_t window, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int64_t G = H / KV, Gb = G < GB_MAX ? G : GB_MAX;
  const int64_t P = BQ / Gb, ngrp = (G + Gb - 1) / Gb;
  const bool vec = sizeof(T) == 4 && hd % 4 == 0 && hd_v % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid((unsigned int)((Sq + P - 1) / P),
                  (unsigned int)(KV * ngrp), (unsigned int)B);
  flash_fwd_kernel<T, FULL><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, (int)H, (int)KV,
      (int)hd, (int)hd_v, window, scale, (int)Gb, (int)ngrp, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd,
           int64_t hd_v, int64_t window, float scale, cudaStream_t stream) {
  if (hd == HD_MAX && hd_v == HD_MAX)
    return run<T, true>(q, k, v, o, B, Sq, Sk, H, KV, hd, hd_v, window,
                        scale, stream);
  return run<T, false>(q, k, v, o, B, Sq, Sk, H, KV, hd, hd_v, window,
                       scale, stream);
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
