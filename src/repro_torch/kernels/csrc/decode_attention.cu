// Single-token decode attention (K8) for Hopper (sm_90a): the one new
// query token of every sequence against its layer's KV cache, read in
// place. Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the Python wrapper (decode_attention.py)
// checks and allocates every tensor and raises on a nonzero return.
//
// It replaces no TPU kernel: the JAX package decodes in plain jnp
// (repro/models/attention.py decode_attend), where XLA fuses the repeat of
// K and V to every query head into the dot. The port's plain version
// (repro_torch/kernels/ref.py decode_attention_ref) materialises that
// repeat over the whole cache, every layer, every step; this kernel reads
// each valid slot of the cache once and writes nothing but the output.
//
// Contract (decode_attention_ref): q (B,1,H,hd), k and v (B,S,KV,hd), f32,
// contiguous and 16-byte aligned, hd a multiple of 4 up to 128, G = H/KV
// of 1 to 8; pos a 0-d int32 or int64 on the card, >= 0; o (B,1,H,hd) f32.
// Query head h reads KV head h / G. Scores s = (q*scale)·k in f32, a
// softmax in f32, o = sum p v / sum p. The valid slots are 0..pos: the
// reference's mask is idx <= pos, or every slot once a sliding window's
// ring has wrapped (pos >= S), which is min(pos + 1, S) slots either way,
// so the window needs no argument here. The rest of the cache is not read.
//
// Bound: bytes. Each valid K and V row is read once (2·B·KV·n·hd·4 bytes
// at n valid slots) for 4·G flop a K/V float: deep under the memory line,
// so no tensor cores (G <= 8 query rows is far below an mma tile, and the
// products stay in f32 FMA). At internlm2-1.8b's decode (B 32, KV 8, hd
// 128) and 257 valid slots that is 67 MB a layer, 20 us at 3.35 TB/s.
//
// Design: split-KV, two launches. (1) split_kernel, grid (ceil(S/64),
// B·KV): a block of 4 warps serves the G query heads of one KV head over
// one chunk of 64 slots. It reads pos from device memory (the launch is
// captured once in a CUDA graph and replayed at every position), and a
// block whose chunk starts past the last valid slot exits at once. Its
// lanes keep the G scaled query rows in registers, 4 floats a lane; a K
// row and its V row are loaded once, as 16-byte vectors by the hd/4 lanes
// of a group (a warp holds 32/(hd/4) groups, each on its own rows, 4 rows
// of K and V in flight a group, 2 when G > 4), and serve all G heads: one
// shuffle reduction a score, then an online softmax (running max m, sum
// l, unnormalised P·V in f32 FMAs) per group, so no scores go through
// memory and a block waits on one chain of loads, K and V together. The
// block merges its groups' states in group order (one barrier) and writes
// the chunk's (m, l, acc) to a scratch buffer the wrapper allocates.
// (2) combine_kernel, a block per (b, KV head): merges the valid chunks
// in order of position, o = sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M)
// l_c. No atomics and a fixed order everywhere: the same inputs give the
// same bits, so a captured decode loop's tokens equal an eager loop's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;             // cache slots a block (one split)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t valid_slots(const void* pos, int pos64,
                                               int64_t S) {
  const int64_t p = pos64 ? *static_cast<const int64_t*>(pos)
                          : (int64_t)*static_cast<const int32_t*>(pos);
  return p + 1 < S ? p + 1 : S;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// G query heads a KV head; LPR lanes a row (hd rounded up to a power of
// two, over 4: 8, 16 or 32)
template <int G, int LPR>
__global__ void __launch_bounds__(THREADS)
split_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const void* __restrict__ pos,
             int pos64, float* __restrict__ acc_out,
             float2* __restrict__ ml_out, int64_t S, int KV, int hd,
             float scale) {
  constexpr int GROUPS = WARPS * (32 / LPR);   // lane groups, a row each
  constexpr int STEPS = CH / GROUPS;           // rows a group
  constexpr int U = G <= 4 ? 4 : 2;            // K and V rows in flight
  constexpr int HDP = 4 * LPR;                 // hd, padded
  __shared__ float2 gml[GROUPS * G];           // each group's (m, l)
  __shared__ __align__(16) float red[GROUPS * G * HDP];

  const int64_t n_valid = valid_slots(pos, pos64, S);
  const int64_t s0 = (int64_t)blockIdx.x * CH;
  if (s0 >= n_valid) return;
  const int n = (int)(n_valid - s0 < CH ? n_valid - s0 : CH);
  const int64_t bk = blockIdx.y;               // b * KV + kv
  const int64_t b = bk / KV;
  const int kv = (int)(bk % KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * (32 / LPR) + lane / LPR;
  const int d = 4 * (lane % LPR);
  const bool on = d < hd;                      // lanes past hd hold zeros
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float ninf = -__int_as_float(0x7f800000);

  float4 qr[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qr[g] = zero;
    if (on) {
      const float4 x = load4(q + (bk * G + g) * hd + d);   // head kv*G + g
      qr[g] = make_float4(x.x * scale, x.y * scale, x.z * scale,
                          x.w * scale);
    }
  }
  const int64_t row = (int64_t)KV * hd;        // one slot to the next
  const int64_t base = ((b * S + s0) * KV + kv) * hd + d;

  // each group's online softmax over its rows: every K and V row is
  // loaded once, both in flight together, and serves all G heads
  float m[G], l[G];
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = ninf;
    l[g] = 0.f;
    acc[g] = zero;
  }
#pragma unroll
  for (int i0 = 0; i0 < STEPS; i0 += U) {
    float4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = (i0 + u) * GROUPS + grp;
      const bool ok = on && j < n;
      kr[u] = ok ? load4(k + base + j * row) : zero;
      vr[u] = ok ? load4(v + base + j * row) : zero;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = dot4(qr[g], kr[u]);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          s[u] += __shfl_xor_sync(FULL, s[u], off);
        if ((i0 + u) * GROUPS + grp >= n) s[u] = ninf;
        mx = fmaxf(mx, s[u]);
      }
      if (mx == ninf) continue;                // no valid row yet
      const float corr = expf(m[g] - mx);      // 0 while m is -inf
      float4 a = make_float4(acc[g].x * corr, acc[g].y * corr,
                             acc[g].z * corr, acc[g].w * corr);
      float sum = l[g] * corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mx);       // 0 for a row past n
        sum += p;
        fma4(a, p, vr[u]);
      }
      m[g] = mx;
      l[g] = sum;
      acc[g] = a;
    }
  }

  // the groups' states merged in group order
  if (lane % LPR == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) gml[grp * G + g] = make_float2(m[g], l[g]);
  }
  if (on) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(&red[(grp * G + g) * HDP + d]) = acc[g];
  }
  __syncthreads();
  const int64_t part = bk * gridDim.x + blockIdx.x;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd, dd = i % hd;
    float M = gml[g].x;                        // group 0 holds row 0
#pragma unroll
    for (int r = 1; r < GROUPS; ++r) M = fmaxf(M, gml[r * G + g].x);
    float L = 0.f, x = 0.f;
#pragma unroll
    for (int r = 0; r < GROUPS; ++r) {
      const float2 ml = gml[r * G + g];
      const float w = ml.x == ninf ? 0.f : expf(ml.x - M);
      L = fmaf(w, ml.y, L);
      x = fmaf(w, red[(r * G + g) * HDP + dd], x);
    }
    acc_out[part * G * hd + i] = x;
    if (dd == 0) ml_out[part * G + g] = make_float2(M, L);
  }
}

// one block per (b, KV head): its G heads' outputs from the valid chunks
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ acc, const float2* __restrict__ ml,
               const void* __restrict__ pos, int pos64, float* __restrict__ o,
               int64_t S, int nsplit, int G, int hd) {
  const int64_t n_valid = valid_slots(pos, pos64, S);
  const int nact = (int)((n_valid + CH - 1) / CH);
  const int64_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const float2* m = ml + bk * nsplit * G + i / hd;       // chunk c: c * G
    const float* a = acc + bk * nsplit * G * hd + i;       // c * G * hd
    // unrolled, so a thread's loads of several chunks are in flight at once
    float M = m[0].x;
#pragma unroll 8
    for (int c = 1; c < nact; ++c) M = fmaxf(M, m[c * G].x);
    float L = 0.f, x = 0.f;
#pragma unroll 4
    for (int c = 0; c < nact; ++c) {
      const float w = expf(m[c * G].x - M);
      L = fmaf(w, m[c * G].y, L);
      x = fmaf(w, a[(int64_t)c * G * hd], x);
    }
    o[bk * G * hd + i] = x / L;      // heads kv*G.. of row b: (b*H + h)*hd
  }
}

template <int G, int LPR>
int run(const float* q, const float* k, const float* v, const void* pos,
        int pos64, float* o, float* part, int64_t B, int64_t S, int64_t KV,
        int64_t hd, float scale, cudaStream_t stream) {
  const int64_t nsplit = (S + CH - 1) / CH;
  float* acc = part;
  float2* ml = reinterpret_cast<float2*>(part + B * KV * nsplit * G * hd);
  const dim3 grid((unsigned int)nsplit, (unsigned int)(B * KV));
  split_kernel<G, LPR><<<grid, THREADS, 0, stream>>>(
      q, k, v, pos, pos64, acc, ml, S, (int)KV, (int)hd, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(unsigned int)(B * KV), THREADS, 0, stream>>>(
      acc, ml, pos, pos64, o, S, (int)nsplit, G, (int)hd);
  return (int)cudaGetLastError();
}

template <int G>
int by_width(const float* q, const float* k, const float* v, const void* pos,
             int pos64, float* o, float* part, int64_t B, int64_t S,
             int64_t KV, int64_t hd, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return run<G, 8>(q, k, v, pos, pos64, o, part, B, S, KV, hd, scale,
                     stream);
  if (hd <= 64)
    return run<G, 16>(q, k, v, pos, pos64, o, part, B, S, KV, hd, scale,
                      stream);
  return run<G, 32>(q, k, v, pos, pos64, o, part, B, S, KV, hd, scale,
                    stream);
}

}  // namespace

extern "C" {

// The wrapper has checked every shape: 1 <= G = H/KV <= 8, hd a multiple
// of 4 in [4, 128], S >= 1, B·KV <= 65535; part holds
// B·KV·ceil(S/64)·G·(hd + 2) floats.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* pos, int pos64, void* o, void* part,
                         int64_t B, int64_t S, int64_t H, int64_t KV,
                         int64_t hd, float scale, cudaStream_t stream) {
  if (KV < 1 || H % KV != 0 || hd < 4 || hd > 128 || hd % 4 != 0 || S < 1 ||
      B < 1 || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* pf = static_cast<float*>(part);
  switch (H / KV) {
#define K8_CASE(g)                                                        \
  case g:                                                                 \
    return by_width<g>(qf, kf, vf, pos, pos64, of, pf, B, S, KV, hd, scale, \
                       stream);
    K8_CASE(1) K8_CASE(2) K8_CASE(3) K8_CASE(4)
    K8_CASE(5) K8_CASE(6) K8_CASE(7) K8_CASE(8)
#undef K8_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
