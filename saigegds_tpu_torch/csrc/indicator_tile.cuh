// The block tile that kernels B3 (indicator_dot_2bit.cu) and B4
// (indicator_dot.cu) share: everything but their staging.
//
// A block owns 32 variants x 128 columns and one range of k (byte columns
// for B3, sample quads for B4, 32 k-quads a stage).  8 warps as 2 x 4 own
// 16 variants x 32 columns x 3 indicators each: 12 m16n8 tiles, 48 s32
// accumulators a thread, where B1's 128 x 128 tile at three indicators
// would need 192.  Shared memory holds, per stage, the code words of the
// block's rows (one 2-bit code a byte, k-quad by k-quad) and the slices'
// B words; rows are padded so that the 32 lanes' fragment reads fall on
// 32 banks.  A warp splits its A fragment words into the three indicator
// words in registers, and every B fragment serves three mmas.  Partial
// sums of the blocks that split k meet in the output through int32
// atomicAdd (exact and order-independent).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace indicator_tile {

constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TB = 32;                      // variants per block
constexpr int TC = 128;                     // columns per block
constexpr int CQ = TC / 4;                  // column quads of a tile
constexpr int JT = 32;                      // k-quads per stage
constexpr int KS = 8;                       // k-quads per mma (k = 32)
constexpr int WN = 32;                      // columns per warp
constexpr int NT = WN / 8;                  // n8 tiles per warp
constexpr int AS = JT + 4;                  // A row stride in words (pad)
constexpr int BS = TC + 8;                  // B row stride in words (pad)
static_assert((TB / 16) * (TC / WN) == WARPS, "2 x 4 warps");
static_assert(JT * CQ % THREADS == 0,
              "every thread stages the same count of B words");

// A lane's place in the tile: g = lane >> 2, t = lane & 3, and its warp's
// first row and column.
struct Lane {
  int g, t, wr, wc;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wr = (warp / (TC / WN)) * 16;
    wc = (warp % (TC / WN)) * WN;
  }
};

// acc[indicator][n8 tile] += the stage's indicators x slices: as[r][q] is
// the code word of row r at k-quad q, bs[q][c] the B word of column c.
__device__ __forceinline__ void contract_stage(const uint32_t (&as)[TB][AS],
                                               const uint32_t (&bs)[JT][BS],
                                               int (&acc)[3][NT][4],
                                               const Lane& l) {
#pragma unroll
  for (int ks = 0; ks < JT; ks += KS) {
    uint32_t b[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b[n][0] = bs[ks + l.t][l.wc + 8 * n + l.g];
      b[n][1] = bs[ks + 4 + l.t][l.wc + 8 * n + l.g];
    }
    const int r = l.wr + l.g;
    const uint32_t cw[4] = {as[r][ks + l.t], as[r + 8][ks + l.t],
                            as[r][ks + 4 + l.t], as[r + 8][ks + 4 + l.t]};
    uint32_t a[3][4];                 // [indicator][fragment register]
#pragma unroll
    for (int i = 0; i < 4; ++i)
      int8_mma::indicators(cw[i], a[0][i], a[1][i], a[2][i]);
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        int8_mma::mma_s8(acc[x][n], a[x][0], a[x][1], a[x][2], a[x][3],
                         b[n][0], b[n][1]);
  }
}

// out[b, x, c] (int32 [B, 3, C]) += acc for the block's rows b0 .. and
// columns c0 ..; rows past B are dropped.
__device__ __forceinline__ void add_to_out(int* __restrict__ out,
                                           const int (&acc)[3][NT][4], int B,
                                           int C, int b0, int c0,
                                           const Lane& l) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bb = b0 + l.wr + 8 * h + l.g;
    if (bb >= B) continue;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        int* o = out + ((long long)bb * 3 + x) * C + c0 + l.wc + 8 * n +
                 2 * l.t;
        atomicAdd(o, acc[x][n][2 * h]);
        atomicAdd(o + 1, acc[x][n][2 * h + 1]);
      }
  }
}

// Zero ``out`` (int32 [B, 3, C]) and launch ``kernel`` over B rows, C
// columns and k_quads k-quads on ``stream``, the k range split so that the
// blocks fill the resident slots about once (the slots' floor: no
// half-empty last wave).  The kernel takes (x, slices, out, B, n, C,
// k-quads per split).  Returns the CUDA error code (0 = success).
template <typename X, typename Kernel>
inline int launch(Kernel kernel, const void* x, const void* slices,
                  void* out, long long B, long long n, long long k_quads,
                  long long C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)B * 3 * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || B == 0 || n == 0 || C == 0) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;

  dim3 grid((unsigned)((B + TB - 1) / TB), (unsigned)(C / TC), 1u);
  const long long tiles = (long long)grid.x * grid.y;
  const long long stages = (k_quads + JT - 1) / JT;
  long long splits = (long long)per_sm * sms / tiles;
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  const long long stages_per = (stages + splits - 1) / splits;
  grid.z = (unsigned)((stages + stages_per - 1) / stages_per);
  kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const X*>(x), static_cast<const int8_t*>(slices),
      static_cast<int*>(out), (int)B, n, (int)C, stages_per * JT);
  return (int)cudaGetLastError();
}

}  // namespace indicator_tile
