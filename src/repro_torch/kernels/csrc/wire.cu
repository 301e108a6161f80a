// Wire kernels K1-K4 of the Eq. 2 compressed model average, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_build.py; the Python wrappers (quantize.py,
// comm.py) check and allocate every tensor and raise on a nonzero return.
//
// Wire format (repro/kernels/quantize.py): rows of BLOCK = 256 f32 values,
// one f32 scale per row. bits 8/4: scale = amax/qmax (qmax 127/7; 1.0 for
// an all-zero row), code = clip(rint(x/scale), -qmax, qmax). bits 1:
// scale = mean|x| (0 for an all-zero row), code = x > 0 ? +1 : -1.
// Dequantized value = code * scale.
//
// Layout on the card: one warp owns one row; lane l holds elements
// l, l+32, ..., l+224, so every warp load or store touches 128 contiguous
// bytes. The row's absmax (or |x| sum) is a register butterfly over the
// warp: all lanes end with the same bits, because each step adds or
// maxes the same two values. Blocks run in no order, and no block reads
// what another writes. The TPU kernels' (ROWS, 256) grid tiling is not
// carried over.
//
// Exactness: built without --use_fast_math and with -fmad=false; the
// intrinsics below spell out IEEE round-to-nearest division, multiply
// and add, and rintf rounds half to even as jnp.round does, so codes and
// scales are bit-exact against the plain versions and only the 1-bit
// mean's summation order differs. Offsets are int64: K * N_pad exceeds
// 2^32 on the main path.
//
// Bound: every kernel here is memory-bound (a few operations per 4-byte
// value, far below the card's ~20 flop/byte f32 ridge). Each reads its
// input once and writes its output once, and keeps every intermediate
// (scale, codes, dequantized values, the running sum over K) in
// registers; none touches device memory twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;             // values per quantization row
constexpr int PER_LANE = BLOCK / 32;   // values a lane holds
constexpr int WARPS = 8;               // rows per thread block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row's scale from the values this lane holds (whole warp calls it).
__device__ __forceinline__ float row_scale(const float (&v)[PER_LANE],
                                           int bits) {
  if (bits == 1) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s = __fadd_rn(s, fabsf(v[j]));
    return __fdiv_rn(warp_sum(s), (float)BLOCK);
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, fabsf(v[j]));
  m = warp_max(m);
  const float qmax = bits == 8 ? 127.f : 7.f;
  return m > 0.f ? __fdiv_rn(m, qmax) : 1.f;
}

__device__ __forceinline__ float code(float x, float scale, int bits) {
  if (bits == 1) return x > 0.f ? 1.f : -1.f;
  const float qmax = bits == 8 ? 127.f : 7.f;
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

__device__ __forceinline__ int64_t warp_row() {
  return (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
}

// K1, replaces repro/kernels/quantize.py:99 quantize_blockwise_fwd
// (_q_kernel :80, _q1_kernel :88). x: n f32 values; rows past n read 0.
// Moves 4n bytes in, n + 4*nb out.
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int64_t n, int64_t nb, int bits) {
  const int64_t row = warp_row();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = row * BLOCK;
  float v[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int64_t i = base + j * 32 + lane;
    v[j] = i < n ? x[i] : 0.f;
  }
  const float s = row_scale(v, bits);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    q[base + j * 32 + lane] = (int8_t)code(v[j], s, bits);
  if (lane == 0) scale[row] = s;
}

// K2, replaces repro/kernels/quantize.py:125 dequantize_blockwise_fwd
// (_dq_kernel :95). Writes the first n values of the (nb, 256) payload.
// Moves n + 4*nb bytes in, 4n out.
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __fmul_rn((float)q[i], scale[i / BLOCK]);
}

// K3, replaces repro/kernels/comm.py:74 quant_avg_dequant_fwd
// (_qad_kernel :51); K4 (with E), replaces comm.py:97
// quant_avg_dequant_ef_fwd (_qad_ef_kernel :57). x, e: (K, n_pad) f32;
// out: (n_pad,) the Eq. 2 mean over K, summed in order k = 0..K-1 and
// divided by K. With E, the quantizer input is y = x + e and the new
// residual y - dq(y) goes to e_out, which may alias e: each value is read
// by the thread that later writes it, and by no other.
// Moves 4*K*n_pad bytes in (twice that with E), 4*n_pad out (plus
// 4*K*n_pad with E).
template <bool E>
__global__ void __launch_bounds__(THREADS)
quant_avg_dequant_kernel(const float* __restrict__ x, const float* e,
                         float* __restrict__ out, float* e_out, int64_t K,
                         int64_t n_pad, int bits) {
  const int64_t row = warp_row();
  if (row >= n_pad / BLOCK) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = row * BLOCK + lane;
  float acc[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) acc[j] = 0.f;
  for (int64_t k = 0; k < K; ++k) {
    const int64_t off = k * n_pad + base;
    float v[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      v[j] = x[off + j * 32];
      if (E) v[j] = __fadd_rn(v[j], e[off + j * 32]);
    }
    const float s = row_scale(v, bits);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const float dq = __fmul_rn(code(v[j], s, bits), s);
      acc[j] = __fadd_rn(acc[j], dq);
      if (E) e_out[off + j * 32] = __fsub_rn(v[j], dq);
    }
  }
  const float kf = (float)K;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    out[base + j * 32] = __fdiv_rn(acc[j], kf);
}

unsigned int row_blocks(int64_t rows) {
  return (unsigned int)((rows + WARPS - 1) / WARPS);
}

}  // namespace

extern "C" {

int wire_quantize(const float* x, int8_t* q, float* scale, int64_t n,
                  int64_t nb, int bits, cudaStream_t stream) {
  if (nb > 0)
    quantize_kernel<<<row_blocks(nb), THREADS, 0, stream>>>(x, q, scale, n,
                                                             nb, bits);
  return (int)cudaGetLastError();
}

int wire_dequantize(const int8_t* q, const float* scale, float* out,
                    int64_t n, cudaStream_t stream) {
  if (n > 0) {
    int64_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
    dequantize_kernel<<<(unsigned int)blocks, THREADS, 0, stream>>>(
        q, scale, out, n);
  }
  return (int)cudaGetLastError();
}

int wire_quant_avg_dequant(const float* x, float* out, int64_t K,
                           int64_t n_pad, int bits, cudaStream_t stream) {
  if (n_pad > 0)
    quant_avg_dequant_kernel<false>
        <<<row_blocks(n_pad / BLOCK), THREADS, 0, stream>>>(
            x, nullptr, out, nullptr, K, n_pad, bits);
  return (int)cudaGetLastError();
}

int wire_quant_avg_dequant_ef(const float* x, const float* e, float* out,
                              float* e_out, int64_t K, int64_t n_pad,
                              int bits, cudaStream_t stream) {
  if (n_pad > 0)
    quant_avg_dequant_kernel<true>
        <<<row_blocks(n_pad / BLOCK), THREADS, 0, stream>>>(
            x, e, out, e_out, K, n_pad, bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
