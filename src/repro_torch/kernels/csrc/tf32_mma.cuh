// Shared pieces of the tensor-core kernels (flash_attention.cu, mlstm.cu):
// f32-accurate products on the TF32 tensor cores ("3xTF32"), the fragments
// of mma.sync.m16n8k8, and cp.async staging of f32 tiles into shared memory.
//
// 3xTF32: an f32 operand x is split into hi = tf32(x) (rounded to nearest,
// 10-bit mantissa) and lo = tf32(x - hi), which together keep 21 of its 24
// bits;
// a product is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b with f32 sums in
// the tensor core (the small terms first). The dropped lo_a*lo_b term is
// below 2^-22 of the product, so the error stays near f32's. Three tensor-
// core products per f32 product: 495 / 3 = 165 TFLOP/s of f32-accurate
// products on an H100 SXM (dense TF32 rate, NVIDIA's data sheet).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k t, n g)  b1 (k t + 4, n g)
//   D (16 x 8):  d0 (g, 2t)  d1 (g, 2t + 1)  d2 (g + 8, 2t)  d3 (g + 8, 2t + 1)
// The loaders read an operand from shared memory through two strides (one
// along the rows of the product, one along its depth): a tile with depth
// contiguous and a row stride of 4 mod 32 floats, or with rows contiguous
// and a depth stride of 8 mod 32, is read without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero: half an ulp of TF32 added to the magnitude bits, the
// 13 low bits cleared), in two integer operations at the full ALU rate; the
// low bits are zero, so hi read back as f32 is the value the tensor core
// multiplies. (cvt's own result leaves them unspecified, and the conversion
// unit issues at a fraction of the ALU rate.)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products, which
// in-order issue needs to hide each product's latency
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b (a zero accumulator)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d[n] += a * b[n] in 3xTF32 for N column tiles sharing one A fragment,
// each pass over all N before the next, so that no product waits on the
// one just issued
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bh[n]);
}

// The same, the three products of this depth-8 step summed apart and then
// added to d in f32 with round-to-nearest. The tensor core adds into its
// accumulator with less care than an f32 add, so a long sum into one
// accumulator (K7's depth of 1024 and its states carried over 2048 steps)
// is kept in f32 registers instead: accumulated in place, K7 errs 5.5e-3 at
// xlstm-1.3b's shape on an H100, 4.0e-4 this way (tools/tc_variants.py).
template <int N>
__device__ __forceinline__ void mma3_rn(float (&d)[N][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const uint32_t (&bh)[N][2],
                                        const uint32_t (&bl)[N][2]) {
  float t[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) mma0(t[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(t[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(t[n], ah, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] += t[n][e];
}

// A fragment of the 16 x 8 tile whose (row 0, depth 0) is at p; element
// (r, c) at p[r * rs + c * ks].
__device__ __forceinline__ void load_a(const float* p, int rs, int ks,
                                       int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  split(p[g * rs + t * ks], hi[0], lo[0]);
  split(p[(g + 8) * rs + t * ks], hi[1], lo[1]);
  split(p[g * rs + (t + 4) * ks], hi[2], lo[2]);
  split(p[(g + 8) * rs + (t + 4) * ks], hi[3], lo[3]);
}

// B fragment of the 8 (depth) x 8 (column) tile at p; element (k, n) at
// p[n * ns + k * ks]
__device__ __forceinline__ void load_b(const float* p, int ns, int ks,
                                       int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int g = lane >> 2, t = lane & 3;
  split(p[g * ns + t * ks], hi[0], lo[0]);
  split(p[g * ns + (t + 4) * ks], hi[1], lo[1]);
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes from global to shared memory, or 16 zero bytes
__device__ __forceinline__ void cp_async16(float* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the rows x cols tile of a row-major global matrix (row stride rs
// elements, starting at src) into shared memory as f32 with row stride ld;
// rows >= rows_ok and columns >= cols_ok become zeros. With ``vec`` (T is
// float, src and rs * 4 bytes 16-byte aligned, cols_ok a multiple of 4) the
// copies are asynchronous 16-byte cp.async (the caller commits and waits);
// otherwise each element is loaded, widened and stored in turn. cols is a
// multiple of 4.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t rs, int rows, int cols,
                                      int rows_ok, int cols_ok, bool vec,
                                      int tid, int nthreads) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const int c4 = cols / 4;
      for (int e = tid; e < rows * c4; e += nthreads) {
        const int r = e / c4, c = (e - r * c4) * 4;
        const bool ok = r < rows_ok && c < cols_ok;
        cp_async16(dst + r * ld + c, ok ? (const void*)(src + r * rs + c)
                                        : (const void*)src, ok);
      }
      return;
    }
  }
  for (int e = tid; e < rows * cols; e += nthreads) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ld + c] =
        r < rows_ok && c < cols_ok ? to_f32(src[r * rs + c]) : 0.f;
  }
}

}  // namespace tc
