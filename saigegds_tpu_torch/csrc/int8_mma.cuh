// The int8 tensor-core helpers shared by the hand-written Hopper kernels:
// B1 and B2 (plane_dot.cu), B3 (indicator_dot_2bit.cu) and B4
// (indicator_dot.cu).  Each source includes this header and is built on
// its own (nvcc -I csrc).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8_mma {

// Byte k of the result is bit pair k of x: plane k's 2-bit code.
__device__ __forceinline__ uint32_t spread_planes(uint32_t x) {
  return (x & 0x03u) | ((x & 0x0Cu) << 6) | ((x & 0x30u) << 12) |
         ((x & 0xC0u) << 18);
}

// 4 x 4 byte transpose: word k of the result holds byte k of w0..w3 (in
// that order, lowest byte first).
__device__ __forceinline__ uint4 transpose4(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410),
                    __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410),
                    __byte_perm(hi01, hi23, 0x7632));
}

// d += a * b on the int8 tensor cores: a is a 16 x 32 s8 tile (row-major
// fragment), b a 32 x 8 s8 tile (column-major fragment), d 16 x 8 s32.
// With g = lane >> 2 and t = lane & 3: a0/a1 hold rows g/g+8 at k 4t..4t+3,
// a2/a3 the same rows at k 16+4t..16+4t+3; b0/b1 hold column g at those k;
// d0,d1 are row g at columns 2t, 2t+1 and d2,d3 row g+8.  No .satfinite:
// the s32 sums wrap like int32, and every caller keeps them exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four bytes of a row that need not start 4-byte aligned, in two steps so
// that the loads are in flight while other work runs.  ``fetch4`` loads the
// aligned words that cover bytes p .. p+n-1 (n in 0..4): nothing when
// n = 0, the second word only when the span reaches into it, so no word
// past the last valid byte is read.  ``bytes4`` funnel-shifts them into
// one word, byte k = p[k] for k < n; the bytes past n hold whatever the
// covering words hold (zero where nothing was read), and the callers meet
// them with zero slices.  ``low`` is the address of p modulo 4.
__device__ __forceinline__ uint2 fetch4(const uint8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int s = static_cast<int>(a & 3);
  uint2 r = make_uint2(0u, 0u);
  if (n > 0) r.x = __ldg(w);
  if (s + n > 4) r.y = __ldg(w + 1);
  return r;
}

__device__ __forceinline__ uint32_t bytes4(uint2 w, uint32_t low) {
  return __funnelshift_r(w.x, w.y, 8 * (low & 3u));
}

// The three indicator words of a word of four 2-bit codes, one code a byte
// (0/1/2, 3 = missing): g0 = the code with missing as 0, m = [code == 3],
// g2 = [code == 2].
__device__ __forceinline__ void indicators(uint32_t cw, uint32_t& g0,
                                           uint32_t& m, uint32_t& g2) {
  const uint32_t hi = cw >> 1;
  m = cw & hi & 0x01010101u;
  g2 = hi & ~cw & 0x01010101u;
  g0 = cw - 3u * m;                  // bytewise: 3 -> 0, no borrow
}

}  // namespace int8_mma
