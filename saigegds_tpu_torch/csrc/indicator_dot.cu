// Scan phase 1 from int8 codes on Hopper: exact integer contraction of
// every variant's genotype indicators with the sliced model vectors, on
// the int8 tensor cores.
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
// vectors, N = 430,000 samples, C = 128) the function reads 110 MB of
// codes and 55 MB of slices, 49 us at 3.35 TB/s, and does 4.2e10
// multiply-adds (8.5e10 int8 operations, 43 us at the int8 tensor-core
// peak): balanced, by a hair on the bytes.  The first version ran the
// multiply-adds on the CUDA cores, four a dot-product instruction
// (1.46 ms); this one runs them on mma.sync.m16n8k32.s32.s8.s8.s32 (no
// .satfinite: exact).
//
// Design.  B3's, with k the sample: the A word of variant b at sample quad
// q is its four code bytes 4q .. 4q+3 as they lie in memory, the B word of
// column c is vs[4q .. 4q+3, c] (transpose4), so one mma covers 16 variants
// x 32 samples x 8 columns.  The block tile, the in-register indicator
// split and the launch are B3's (indicator_tile.cuh).  Per stage (32
// sample quads) a thread loads the next stage's global bytes into
// registers before the current stage's mmas.  Two blocks per SM.  Rows
// start at b * N, which is 4-byte aligned for one sample count in four: a
// thread loads the aligned words that cover its four codes and
// funnel-shifts them (int8_mma.cuh fetch4 / bytes4).  Samples at or past N
// meet zero slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "indicator_tile.cuh"

namespace {

using namespace indicator_tile;
using namespace int8_mma;

static_assert(TB * JT % THREADS == 0,
              "every thread stages the same count of A words");

__global__ void __launch_bounds__(THREADS, 2)
indicator_dot_kernel(const int8_t* __restrict__ codes,
                     const int8_t* __restrict__ vs, int* __restrict__ out,
                     int B, long long N, int C, long long quads_per_split) {
  // A, row r: code words of variant b0 + r (byte k = sample 4q + k)
  __shared__ __align__(16) uint32_t as[TB][AS];            // 4.5 KB
  // B, quad q: word c holds vs[4q .. 4q+3, c0 + c]
  __shared__ __align__(16) uint32_t bs[JT][BS];            // 17 KB
  constexpr int A_IT = TB * JT / THREADS;       // code words a thread
  constexpr int B_IT = JT * CQ / THREADS;       // (quad, column quad)s

  const Lane lane;
  const int b0 = blockIdx.x * TB;
  const int c0 = blockIdx.y * TC;
  const long long NQ = (N + 3) / 4;
  const long long jbeg = (long long)blockIdx.z * quads_per_split;
  const long long jend = min(NQ, jbeg + quads_per_split);
  const long long send = min(N, 4 * jend);      // the split's last sample

  // One stage's global reads, held in registers while the previous stage
  // computes.  Slices past the split's last sample read as 0; codes there
  // may hold any value and meet those zero slices, and rows past B read
  // as 0 and are never written out.
  uint2 ra[A_IT];
  uint32_t rb[B_IT][4];
  auto fetch = [&](long long j0) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int b = b0 + e / JT;
      const long long s0 = 4 * (j0 + e % JT);
      ra[it] = fetch4(reinterpret_cast<const uint8_t*>(codes) +
                          (long long)b * N + s0,
                      b < B ? (int)max(0LL, min(4LL, send - s0)) : 0);
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const long long s0 = 4 * (j0 + e / CQ);
      const int8_t* src = vs + s0 * C + c0 + 4 * (e % CQ);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rb[it][k] = s0 + k < send ? *reinterpret_cast<const uint32_t*>(
                                        src + (long long)k * C)
                                  : 0u;
    }
  };
  // ... then masked to 2-bit codes (A) and transposed (B) in shared memory
  auto stash = [&]() {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      // the row's start modulo 4 (sample quads start 4-byte apart)
      const uint32_t low = (uint32_t)reinterpret_cast<uintptr_t>(codes) +
                           (uint32_t)(b0 + e / JT) * (uint32_t)N;
      as[e / JT][e % JT] = bytes4(ra[it], low) & 0x03030303u;
    }
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

// Zero ``out`` and launch on ``stream``.  B, N, C as above; C must be a
// multiple of 128 and ``vs`` 4-byte aligned (the caller checks); ``codes``
// may start at any byte.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int sg_indicator_dot(const void* codes, const void* vs, void* out,
                                long long B, long long N, long long C,
                                int device, void* stream) {
  return indicator_tile::launch<int8_t>(indicator_dot_kernel, codes, vs,
                                        out, B, N, (N + 3) / 4, C, device,
                                        stream);
}
