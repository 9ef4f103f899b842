// Scan phase 1 on Hopper: fused planar 2-bit decode + exact integer
// contraction of every variant's genotype indicators with the sliced model
// vectors, on the int8 tensor cores through the warpgroup MMA (wgmma) with
// the slices brought in by TMA.
//
// Replaces saigegds_tpu/ops/pallas_score.py::_kernel2 (the Pallas body of
// indicator_dot_2bit).  For a block of B variants, packed as uint8 [B, N4]
// (byte j, bit pair p = the code of sample p*N4 + j; 3 = missing), and the
// int8 slices vs4 [4, N4, C] of the 2K+3 model vectors (|value| <= 64, zero
// rows at padded samples), it writes int32 out [B, 3, C]:
//   out[b, 0, c] = sum_i g0(code) * vs[i, c]   g0 = code, missing -> 0
//   out[b, 1, c] = sum_i [code == 3] * vs[i, c]
//   out[b, 2, c] = sum_i [code == 2] * vs[i, c]
// Every product is an integer of at most 2 * 64 = 128, so int32 sums are
// exact for any N < 2^24 samples (128 * N < 2^31).  The Pallas kernel's
// 2^17-sample segments existed only for f32 accumulators; there are none.
//
// What bounds it.  At the main-path shape (B = 1024 variants, N = 430,000
// samples, C = 96 columns: a model of three covariates, 88 live) the
// function reads 110 MB of packed codes and 41 MB of slices (45 us at
// 3.35 TB/s) and does 3 * B * N * C = 1.3e14 multiply-adds, 2.5e14 int8
// operations: 0.128 ms at the dense int8 tensor-core peak of 1,979 TOP/s, a
// rate only wgmma reaches.  So it is bound by operations.  The first
// version ran them on the CUDA cores (__dp4a, 4.97 ms at C = 128), the
// second on mma.sync m16n8k32 (0.93 ms at C = 128).
//
// Design: the tile of indicator_tile.cuh (a producer warpgroup keeping TMA
// loads of the slices' tiles in flight, two consumer warpgroups of 64
// variants x BN columns x three indicators issuing wgmma m64nBNk32 with A
// from registers), with this policy for the codes.  k runs over (stage
// group G of 32 byte columns, plane p, half w, quad thread t, byte i): a
// thread reads 8 packed bytes of each of its rows at byte column 8t of the
// stage, words w = 0, 1, and the A word of k-step p, half w is plane p of
// word w, one shift and one mask: byte i holds the code of byte column
// 8t + 4w + i.  The indicators are split on the packed word first (three
// logic operations for 16 codes), so the three A words of a plane cost two
// operations each.  The slices are laid out in that order once per model
// (ops/score_kernel.py operand_2bit): byte 128 G + 32 p + 16 w + 4 t + i
// of column c is vs4[p, 32 G + 8 t + 4 w + i, c], zero past N4.  Rows need
// not start aligned (N4 = ceil(N/4) is odd for half the sample counts):
// the payload keeps the layout the host packs.

#include <cstdint>
#include <cuda_runtime.h>

#include "indicator_tile.cuh"

namespace {

using indicator_tile::AFrag;
using indicator_tile::LOW2;

// Planar 2-bit rows: a thread's 8 bytes of a row per stage (32 byte
// columns, 128 k).
struct Planar2 {
  static constexpr int SPAN = 8;

  // The slices' width in k for rows of n4 bytes: four planes of n4
  // rounded up to a stage's 32 byte columns.
  static constexpr long long width(long long n4) {
    return 4 * ((n4 + 31) / 32 * 32);
  }

  // The three indicators' A words of one row (rh: g or g + 8).  On a
  // packed word, per 2-bit field: m = [code == 3] and g2 = [code == 2] in
  // the field's low bit, g0 = code - 3 m (no borrow: the field holds 3
  // wherever m does).
  static __device__ __forceinline__ void build(
      const indicator_tile::Span<SPAN>& raw, AFrag& a, int rh) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const uint32_t x = raw.word(w);
      const uint32_t hi = x >> 1;
      const uint32_t m = x & hi & 0x55555555u;
      const uint32_t g2 = hi & ~x & 0x55555555u;
      const uint32_t g0 = x - 3u * m;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[0][p][rh + 2 * w] = (g0 >> (2 * p)) & LOW2;
        a[1][p][rh + 2 * w] = (m >> (2 * p)) & LOW2;
        a[2][p][rh + 2 * w] = (g2 >> (2 * p)) & LOW2;
      }
    }
  }
};

}  // namespace

// Zero ``out`` and launch on ``stream`` with column tiles of ``bn``.  B,
// N4, C as above; ``packed`` may start at any byte; ``vs4k`` is the slices
// in the kernel's order, int8 [C, 4 N4p] (N4p = N4 rounded up to 32; see
// the header), 16-byte aligned.  ``bn`` is 32, 64 or 96 and divides C,
// else cudaErrorInvalidValue.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int sg_indicator_dot_2bit(const void* packed, const void* vs4k,
                                     void* out, long long B, long long N4,
                                     long long C, int bn, int device,
                                     void* stream) {
  return indicator_tile::run<Planar2>(packed, vs4k, out, B, N4, C, bn,
                                      device, stream);
}
