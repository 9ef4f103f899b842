// Scan phase 1 from int8 codes on Hopper: exact integer contraction of
// every variant's genotype indicators with the sliced model vectors, on
// the int8 tensor cores through the warpgroup MMA (wgmma) with the slices
// brought in by TMA.
//
// Replaces saigegds_tpu/ops/pallas_score.py::_kernel (the Pallas body of
// indicator_dot).  For B variants as int8 codes [B, N] (0/1/2, 3 = missing)
// and the int8 slices vs [N, C] of the 2K+3 model vectors (|value| <= 64),
// it writes int32 out [B, 3, C]:
//   out[b, 0, c] = sum_i g0(code) * vs[i, c]   g0 = code, missing -> 0
//   out[b, 1, c] = sum_i [code == 3] * vs[i, c]
//   out[b, 2, c] = sum_i [code == 2] * vs[i, c]
// It is kernel B3 (indicator_dot_2bit.cu) at one byte per genotype and
// without the plane split.  Every product is an integer of at most
// 2 * 64 = 128, so int32 sums are exact for any N < 2^24 samples; the
// Pallas kernel's 131,072-sample f32 segments are not needed.
//
// What bounds it.  At the aggregate's main-path shape (B = 256 test
// vectors, N = 430,000 samples, C = 96: a model of three covariates, 88
// live) the function reads 110 MB of codes and 41 MB of slices, 45 us at
// 3.35 TB/s, and does 3.2e10 multiply-adds (6.3e10 int8 operations, 32 us
// at the int8 tensor-core peak): bound by the bytes.  The first version ran
// the multiply-adds on the CUDA cores (__dp4a, 1.46 ms at C = 128), the
// second on mma.sync m16n8k32 (0.29 ms at C = 128).
//
// Design: the tile of indicator_tile.cuh (a producer warpgroup keeping TMA
// loads of the slices' tiles in flight, two consumer warpgroups of 64
// variants x BN columns x three indicators issuing wgmma m64nBNk32 with A
// from registers), with this policy for the codes.  k runs over (stage
// group G of 128 samples, k-step s, half h, quad thread t, byte i): a
// thread reads 32 consecutive code bytes of each of its rows, samples
// 32 t .. 32 t + 31 of the stage, as words j = 0 .. 7, and word j is the A
// word of k-step j / 2, half j % 2, as it lies in memory.  Each code word
// splits into its three indicator words in four operations.  The slices
// are laid out in that order once per model (ops/score_kernel.py
// operand): byte 128 G + 32 s + 16 h + 4 t + i of column c is
// vs[128 G + 32 t + 8 s + 4 h + i, c], zero at samples at or past N.  Rows
// start at b * N, aligned for one sample count in four: the payload keeps
// the layout the host packs.

#include <cstdint>
#include <cuda_runtime.h>

#include "indicator_tile.cuh"

namespace {

using indicator_tile::AFrag;
using indicator_tile::LOW2;

// int8 code rows: a thread's 32 bytes of a row per stage (128 samples).
struct Bytes {
  static constexpr int SPAN = 32;

  // The slices' width in k for rows of n samples: n rounded up to a
  // stage's 128.
  static constexpr long long width(long long n) {
    return (n + 127) / 128 * 128;
  }

  // The three indicators' A words of one row (rh: g or g + 8), byte by
  // byte: m = [code == 3], g2 = [code == 2], g0 = code - 3 m.
  static __device__ __forceinline__ void build(
      const indicator_tile::Span<SPAN>& raw, AFrag& a, int rh) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t c = raw.word(j) & LOW2;
      const uint32_t hi = c >> 1;
      const uint32_t m = c & hi & 0x01010101u;
      const uint32_t r = rh + 2 * (j & 1);
      a[0][j >> 1][r] = c - 3u * m;
      a[1][j >> 1][r] = m;
      a[2][j >> 1][r] = hi & ~c & 0x01010101u;
    }
  }
};

}  // namespace

// Zero ``out`` and launch on ``stream`` with column tiles of ``bn``.  B, N,
// C as above; ``codes`` may start at any byte; ``vsk`` is the slices in the
// kernel's order, int8 [C, Np] (Np = N rounded up to 128; see the header),
// 16-byte aligned.  ``bn`` is 32, 64 or 96 and divides C, else
// cudaErrorInvalidValue.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int sg_indicator_dot(const void* codes, const void* vsk,
                                void* out, long long B, long long N,
                                long long C, int bn, int device,
                                void* stream) {
  return indicator_tile::run<Bytes>(codes, vsk, out, B, N, C, bn, device,
                                    stream);
}
