// Scan phase 1 on Hopper: fused planar 2-bit decode + exact integer
// contraction of every variant's genotype indicators with the sliced model
// vectors, on the int8 tensor cores.
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
// samples, C = 128 columns) the function reads 110 MB of packed codes and
// 55 MB of slices (50 us at 3.35 TB/s) and does 3 * B * N * C = 1.7e14
// multiply-adds, 3.4e14 int8 operations: 0.171 ms at the dense int8
// tensor-core peak of 1,979 TOP/s, a rate only wgmma reaches.  So it is
// bound by operations.  The first version ran them on the CUDA cores, four
// samples a dot-product instruction (4.97 ms); this one runs them on
// mma.sync.m16n8k32.s32.s8.s8.s32 (no .satfinite: exact).
//
// Design.  k runs over (byte column j, plane p), as in B1 (plane_dot.cu):
// the A word of variant b at byte column j is its packed byte with each bit
// pair spread to a byte (spread_planes), the B word of column c is the four
// planes' slice bytes vs4[0..3, j, c] (transpose4), so one mma covers 16
// variants x 8 byte columns (32 samples) x 8 columns.  The block tile, the
// in-register indicator split and the launch are B4's too
// (indicator_tile.cuh).  Per stage (32 byte columns) a thread loads the
// next stage's global bytes into registers before the current stage's
// mmas, then spreads them into shared memory.  Two blocks per SM.  Rows
// need not start 4-byte aligned (N4 = ceil(N/4) % 4 != 0 for three of four
// sample counts): a thread loads the aligned words that cover its four
// bytes and funnel-shifts them (int8_mma.cuh fetch4 / bytes4), so the
// payload keeps the layout the host packs.

#include <cstdint>
#include <cuda_runtime.h>

#include "indicator_tile.cuh"

namespace {

using namespace indicator_tile;
using namespace int8_mma;

static_assert(TB * (JT / 4) == THREADS, "one A word a thread");

__global__ void __launch_bounds__(THREADS, 2)
indicator_dot_2bit_kernel(const uint8_t* __restrict__ packed,
                          const int8_t* __restrict__ vs4,
                          int* __restrict__ out, int B, long long N4, int C,
                          long long cols_per_split) {
  // A, row r: spread planes of the stage's packed bytes of variant b0 + r
  __shared__ __align__(16) uint32_t as[TB][AS];            // 4.5 KB
  // B, byte column jj: word c holds planes 0..3 of column c0 + c
  __shared__ __align__(16) uint32_t bs[JT][BS];            // 17 KB
  constexpr int B_IT = JT * CQ / THREADS;       // column quads a thread

  const Lane lane;
  const int b0 = blockIdx.x * TB;
  const int c0 = blockIdx.y * TC;
  const long long jbeg = (long long)blockIdx.z * cols_per_split;
  const long long jend = min(N4, jbeg + cols_per_split);
  // the thread's A word: four byte columns of one row
  const int ra_row = threadIdx.x / (JT / 4);
  const int ra_col = 4 * (threadIdx.x % (JT / 4));
  const uint8_t* ra_src = packed + (long long)(b0 + ra_row) * N4 + ra_col;
  const bool ra_live = b0 + ra_row < B;
  // the row's start modulo 4 (stages and ra_col are multiples of 4)
  const uint32_t ra_low = (uint32_t)reinterpret_cast<uintptr_t>(ra_src);

  // One stage's global reads, held in registers while the previous stage
  // computes.  Rows past B read as code 0; bytes past the range may hold
  // any code and meet zero slices, as bytes past B's rows meet nothing.
  uint2 ra;
  uint32_t rb[B_IT][4];
  auto fetch = [&](long long j0) {
    const long long left = jend - (j0 + ra_col);
    ra = fetch4(ra_src + j0,
                ra_live ? (int)max(0LL, min(4LL, left)) : 0);
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const long long j = j0 + e / CQ;
      const int8_t* src = vs4 + j * C + c0 + 4 * (e % CQ);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        rb[it][p] = j < jend ? *reinterpret_cast<const uint32_t*>(
                                   src + (long long)p * N4 * C)
                             : 0u;
    }
  };
  // ... then spread into A and transposed into B in shared memory
  auto stash = [&]() {
    const uint32_t x = bytes4(ra, ra_low);
    *reinterpret_cast<uint4*>(&as[ra_row][ra_col]) =
        make_uint4(spread_planes(x & 0xFFu), spread_planes((x >> 8) & 0xFFu),
                   spread_planes((x >> 16) & 0xFFu), spread_planes(x >> 24));
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      *reinterpret_cast<uint4*>(&bs[e / CQ][4 * (e % CQ)]) =
          transpose4(rb[it][0], rb[it][1], rb[it][2], rb[it][3]);
    }
  };

  int acc[3][NT][4] = {};             // [indicator][n8 tile][fragment]
  if (jbeg < jend) fetch(jbeg);
  for (long long j0 = jbeg; j0 < jend; j0 += JT) {
    stash();
    __syncthreads();
    if (j0 + JT < jend) fetch(j0 + JT);       // in flight during the mmas
    contract_stage(as, bs, acc, lane);
    __syncthreads();
  }
  add_to_out(out, acc, B, C, b0, c0, lane);
}

}  // namespace

// Zero ``out`` and launch on ``stream``.  B, N4, C as above; C must be a
// multiple of 128 and ``vs4`` 4-byte aligned (the caller checks); ``packed``
// may start at any byte.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int sg_indicator_dot_2bit(const void* packed, const void* vs4,
                                     void* out, long long B, long long N4,
                                     long long C, int device, void* stream) {
  return indicator_tile::launch<uint8_t>(indicator_dot_2bit_kernel, packed,
                                         vs4, out, B, N4, N4, C, device,
                                         stream);
}
