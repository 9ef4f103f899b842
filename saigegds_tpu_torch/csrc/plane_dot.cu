// The two passes of the 2-bit GRM matvec on Hopper: fused planar 2-bit
// decode + exact integer contraction against signed-7-bit slices on the
// int8 tensor cores.
//
// Replaces saigegds_tpu/ops/pallas_grm.py::_fwd_kernel (kernel B1, the
// Pallas body of plane_dot_fwd) and ::_t_kernel (kernel B2, the body of
// plane_dot_t).  The genotype store is uint8 packed [M, N4]: byte j of
// variant m holds the codes of samples p*N4 + j in bit pairs p = 0..3, with
// missing already zeroed, so every code is 0, 1 or 2.
//
//   B1 (pass 1):  out[m, c]    = sum_p sum_j code_p(packed[m, j]) * d4[p, j, c]
//   B2 (pass 2):  out[p, j, c] = sum_m code_p(packed[m, j]) * dm[m, c]
//
// d4 [4, N4, C] and dm [M, C] are int8 slices with |value| <= 64 (zero at
// padded samples and columns).  Every product is an integer of at most
// 2 * 64 = 128, so s32 sums are exact for N < 2^24 samples (B1) and for
// M < 2^24 variants (B2); the Pallas kernels' 2^17-sample and
// 131,072-variant segments existed only for their f32 accumulators.
// Every packed row must start 4-byte aligned (N4 % 4 == 0 and an aligned
// base): the staging loads four byte columns of a row as one 32-bit word.
// The port's GRM store pads N4 so (ops/packed_grm.py store_width); the
// entry points refuse other stores.
//
// What bounds them.  At the fit's main-path shape (M = 16,384 variants,
// N = 430,000 samples, C = 128 columns) each pass is 1.8e12 int8 operations
// (0.91 ms at the H100's dense int8 tensor-core peak of 1,979 TOP/s, a
// rate only wgmma reaches; the warp-level mma.sync used here reaches a
// part of it) and reads 1.76 GB of packed codes once (0.53 ms at 3.35
// TB/s).  The slices are small (d4 55 MB, dm 2 MB at C = 128) but every
// block re-reads its column tile of them: d4 once per 128 variants and dm
// once per 32 byte columns, ~7 GB each from L2.
//
// Both kernels contract on mma.sync.m16n8k32.s32.s8.s8.s32 (no .satfinite:
// exact).  The fragments need no shuffle: a 32-bit A or B register holds
// four consecutive k, and the staging already builds such words.  A block
// owns a 128 x 128 output tile; 8 warps as 2 x 4 own 64 x 32 each (4 x 4
// m16n8 tiles, 64 s32 accumulators a thread).  Per stage (k = 128 bytes
// of each operand row) a thread loads the next stage's global bytes into
// registers before the current stage's mmas, so the load latency hides
// behind them; the operand words sit in shared memory with rows padded so
// that the 32 lanes' fragment reads fall on 32 banks.  Two blocks per SM.
// Left to a later wgmma + TMA design: A and B read by the tensor cores
// straight from shared memory (here every fragment costs a shared load,
// which with the __syncthreads per stage holds these kernels near a fifth
// of the peak), multicast of the slice tiles to the blocks of a cluster
// (the L2 re-reads above), and column tiles narrower than 128.
//
// B1.  k runs over (byte column j, plane p): the A word of variant m at
// byte column j is its packed byte with each bit pair spread to a byte
// (spread_planes), the B word of column c is the four planes' slice bytes
// d4[0..3, j, c] (transpose4).  One mma covers 16 variants x 8 byte columns
// (32 samples) x 8 columns.  Blocks split the sample axis so that the
// resident slots fill once; partial sums meet in the output through int32
// atomicAdd (exact and order-independent).
//
// B2.  The output rows are (plane p, byte column j), an m16 tile being 16
// byte columns of one plane, and k is the variant: the A word of row
// (p, j) is plane p of four consecutive variants' bytes at j, the B word of
// column c is dm[m .. m+3, c] (transpose4 both).  A block owns 32 byte
// columns (128 output rows) and loops over all M by itself: with N4 / 32
// blocks (3,360 at N = 430,000) the card is full without splitting M, so
// there are no atomics and the result is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using int8_mma::mma_s8;
using int8_mma::spread_planes;
using int8_mma::transpose4;

constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TC = 128;                     // columns per block
constexpr int CQ = TC / 4;                  // column quads of a tile

// B1 tiling (int8 tensor cores, mma.sync m16n8k32)
constexpr int F_TB = 128;                   // variants per block
constexpr int F_JT = 32;                    // byte columns per stage
constexpr int F_KS = 8;                     // byte columns per mma (k = 32)
constexpr int F_WM = 64;                    // variants per warp (2 x 4 warps)
constexpr int F_WN = 32;                    // columns per warp
constexpr int F_MT = F_WM / 16;             // m16 tiles per warp
constexpr int F_NT = F_WN / 8;              // n8 tiles per warp
constexpr int F_AS = F_JT + 4;              // A row stride in words (pad)
constexpr int F_BS = TC + 8;                // B row stride in words (pad)
static_assert((F_TB / F_WM) * (TC / F_WN) == WARPS, "2 x 4 warps");
static_assert(F_JT % F_KS == 0 && F_AS % 4 == 0 && F_BS % 4 == 0,
              "16-byte staging stores");
static_assert(F_TB * (F_JT / 4) % THREADS == 0 && F_JT * CQ % THREADS == 0,
              "every thread stages the same count of words");

// B2 tiling: output rows (plane p, byte column jj) as p * T_JW + jj
constexpr int T_JW = 32;                    // byte columns per block
constexpr int T_TR = 4 * T_JW;              // output rows per block
constexpr int T_MQ = 32;                    // variant quads per stage
constexpr int T_KQ = 8;                     // variant quads per mma (k = 32)
constexpr int T_WM = 64;                    // output rows per warp
constexpr int T_WN = 32;                    // columns per warp
constexpr int T_MT = T_WM / 16;             // m16 tiles per warp
constexpr int T_NT = T_WN / 8;              // n8 tiles per warp
constexpr int T_AS = T_TR + 8;              // A row stride in words (pad)
constexpr int T_BS = TC + 8;                // B row stride in words (pad)
static_assert((T_TR / T_WM) * (TC / T_WN) == WARPS, "2 x 4 warps");
static_assert(T_WM % 16 == 0 && T_JW % 16 == 0,
              "an m16 tile is 16 byte columns of one plane");
static_assert(T_MQ * CQ % THREADS == 0,
              "every thread stages the same count of words");

// B1: a block owns 128 variants x 128 columns x one split of the byte
// columns.
__global__ void __launch_bounds__(THREADS, 2)
plane_dot_fwd_kernel(const uint8_t* __restrict__ packed,
                     const int8_t* __restrict__ d4, int* __restrict__ out,
                     int M, long long N4, int C, long long cols_per_split) {
  // k runs over (byte column j, plane p): one word holds the four planes
  // of one byte column, so the mma's k = 32 is 8 byte columns.
  // A, row r: spread planes of the stage's packed bytes of variant m0 + r
  __shared__ __align__(16) uint32_t as[F_TB][F_AS];        // 18 KB
  // B, byte column jj: word c holds planes 0..3 of column c0 + c
  __shared__ __align__(16) uint32_t bs[F_JT][F_BS];        // 17 KB
  constexpr int A_IT = F_TB * (F_JT / 4) / THREADS;   // byte quads a thread
  constexpr int B_IT = F_JT * CQ / THREADS;           // column quads a thread

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / (TC / F_WN)) * F_WM;   // warp's first row
  const int wc = (warp % (TC / F_WN)) * F_WN;   // warp's first column
  const int m0 = blockIdx.x * F_TB;
  const int c0 = blockIdx.y * TC;
  const long long jbeg = (long long)blockIdx.z * cols_per_split;
  const long long jend = min(N4, jbeg + cols_per_split);

  // One stage's global reads, held in registers while the previous stage
  // computes; bytes past the range or past M read as code 0.
  uint32_t ra[A_IT], rb[B_IT][4];
  auto fetch = [&](long long j0) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int m = m0 + e / (F_JT / 4);
      const long long j = j0 + 4 * (e % (F_JT / 4));
      // jend is a multiple of 4 (N4 and the split are)
      ra[it] = (m < M && j < jend) ? *reinterpret_cast<const uint32_t*>(
                                         packed + (long long)m * N4 + j)
                                   : 0u;
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const long long j = j0 + e / CQ;
      const int8_t* src = d4 + j * C + c0 + 4 * (e % CQ);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        rb[it][p] = j < jend ? *reinterpret_cast<const uint32_t*>(
                                   src + (long long)p * N4 * C)
                             : 0u;
    }
  };
  // ... then spread into A and transposed into B in shared memory
  auto stash = [&]() {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const uint32_t x = ra[it];
      *reinterpret_cast<uint4*>(&as[e / (F_JT / 4)][4 * (e % (F_JT / 4))]) =
          make_uint4(spread_planes(x & 0xFFu), spread_planes((x >> 8) & 0xFFu),
                     spread_planes((x >> 16) & 0xFFu), spread_planes(x >> 24));
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      *reinterpret_cast<uint4*>(&bs[e / CQ][4 * (e % CQ)]) =
          transpose4(rb[it][0], rb[it][1], rb[it][2], rb[it][3]);
    }
  };

  int acc[F_MT][F_NT][4];
#pragma unroll
  for (int i = 0; i < F_MT; ++i)
#pragma unroll
    for (int n = 0; n < F_NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][n][k] = 0;

  if (jbeg < jend) fetch(jbeg);
  for (long long j0 = jbeg; j0 < jend; j0 += F_JT) {
    stash();
    __syncthreads();
    if (j0 + F_JT < jend) fetch(j0 + F_JT);   // in flight during the mmas

#pragma unroll
    for (int ks = 0; ks < F_JT; ks += F_KS) {
      uint32_t b[F_NT][2];
#pragma unroll
      for (int n = 0; n < F_NT; ++n) {
        b[n][0] = bs[ks + t][wc + 8 * n + g];
        b[n][1] = bs[ks + 4 + t][wc + 8 * n + g];
      }
#pragma unroll
      for (int i = 0; i < F_MT; ++i) {
        const int r = wr + 16 * i + g;
        const uint32_t a0 = as[r][ks + t], a1 = as[r + 8][ks + t];
        const uint32_t a2 = as[r][ks + 4 + t], a3 = as[r + 8][ks + 4 + t];
#pragma unroll
        for (int n = 0; n < F_NT; ++n)
          mma_s8(acc[i][n], a0, a1, a2, a3, b[n][0], b[n][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < F_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wr + 16 * i + 8 * h + g;
      if (m >= M) continue;
#pragma unroll
      for (int n = 0; n < F_NT; ++n) {
        int* o = out + (long long)m * C + c0 + wc + 8 * n + 2 * t;
        atomicAdd(o, acc[i][n][2 * h]);
        atomicAdd(o + 1, acc[i][n][2 * h + 1]);
      }
    }
}

// B2.  k is the variant: one word holds four consecutive variants, so the
// mma's k = 32 is 8 variant quads.  An m16 tile is 16 byte columns of one
// plane.
__global__ void __launch_bounds__(THREADS, 2)
plane_dot_t_kernel(const uint8_t* __restrict__ packed,
                   const int8_t* __restrict__ dm, int* __restrict__ out,
                   int M, long long N4, int C) {
  // A, quad q: word p * T_JW + jj holds plane p's codes of variants
  // mb + 4q .. mb + 4q + 3 at byte column jb + jj
  __shared__ __align__(16) uint32_t as[T_MQ][T_AS];        // 17 KB
  // B, quad q: word c holds dm[mb + 4q .. +3, c0 + c]
  __shared__ __align__(16) uint32_t bs[T_MQ][T_BS];        // 17 KB
  constexpr int A_IT = T_MQ * (T_JW / 4) / THREADS;   // (quad, 4 columns)s
  constexpr int B_IT = T_MQ * CQ / THREADS;           // (quad, column quad)s
  static_assert(A_IT == 1, "one quad of rows x four byte columns a thread");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / (TC / T_WN)) * T_WM;   // warp's first output row
  const int wc = (warp % (TC / T_WN)) * T_WN;   // warp's first column
  const long long jb = (long long)blockIdx.x * T_JW;
  const int c0 = blockIdx.y * TC;
  const int q_a = threadIdx.x / (T_JW / 4);     // the thread's A quad
  const int jq_a = 4 * (threadIdx.x % (T_JW / 4));
  const long long j_a = jb + jq_a;

  // One stage's global reads, held in registers while the previous stage
  // computes: four variants' bytes at four byte columns (A) and four
  // variants' slices at four columns (B).  Rows past M and byte columns
  // past N4 read as code 0.
  uint32_t ra[4], rb[B_IT][4];
  auto fetch = [&](int mb) {
    const int m = mb + 4 * q_a;
#pragma unroll
    for (int k = 0; k < 4; ++k)    // N4 is a multiple of 4
      ra[k] = (m + k < M && j_a < N4) ? *reinterpret_cast<const uint32_t*>(
                                            packed + (long long)(m + k) * N4 +
                                            j_a)
                                      : 0u;
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int m = mb + 4 * (e / CQ);
      const int8_t* src = dm + (long long)m * C + c0 + 4 * (e % CQ);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rb[it][k] = m + k < M ? *reinterpret_cast<const uint32_t*>(
                                    src + (long long)k * C)
                              : 0u;
    }
  };
  // ... then transposed to one word of four variants per byte column and
  // split into plane words (A), and transposed (B), in shared memory
  auto stash = [&]() {
    const uint4 x = transpose4(ra[0], ra[1], ra[2], ra[3]);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint4*>(&as[q_a][p * T_JW + jq_a]) = make_uint4(
          (x.x >> (2 * p)) & 0x03030303u, (x.y >> (2 * p)) & 0x03030303u,
          (x.z >> (2 * p)) & 0x03030303u, (x.w >> (2 * p)) & 0x03030303u);
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      *reinterpret_cast<uint4*>(&bs[e / CQ][4 * (e % CQ)]) =
          transpose4(rb[it][0], rb[it][1], rb[it][2], rb[it][3]);
    }
  };

  int acc[T_MT][T_NT][4];
#pragma unroll
  for (int i = 0; i < T_MT; ++i)
#pragma unroll
    for (int n = 0; n < T_NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][n][k] = 0;

  fetch(0);
  for (int mb = 0; mb < M; mb += 4 * T_MQ) {
    stash();
    __syncthreads();
    if (mb + 4 * T_MQ < M) fetch(mb + 4 * T_MQ);   // in flight during mmas

#pragma unroll
    for (int ks = 0; ks < T_MQ; ks += T_KQ) {
      uint32_t b[T_NT][2];
#pragma unroll
      for (int n = 0; n < T_NT; ++n) {
        b[n][0] = bs[ks + t][wc + 8 * n + g];
        b[n][1] = bs[ks + 4 + t][wc + 8 * n + g];
      }
#pragma unroll
      for (int i = 0; i < T_MT; ++i) {
        const int r = wr + 16 * i + g;
        const uint32_t a0 = as[ks + t][r], a1 = as[ks + t][r + 8];
        const uint32_t a2 = as[ks + 4 + t][r], a3 = as[ks + 4 + t][r + 8];
#pragma unroll
        for (int n = 0; n < T_NT; ++n)
          mma_s8(acc[i][n], a0, a1, a2, a3, b[n][0], b[n][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T_MT; ++i) {
    const int p = (wr + 16 * i) / T_JW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = jb + (wr + 16 * i) % T_JW + 8 * h + g;
      if (j >= N4) continue;
      int* o = out + ((long long)p * N4 + j) * C + c0 + wc + 2 * t;
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
        *reinterpret_cast<int2*>(o + 8 * n) =
            make_int2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
    }
  }
}

}  // namespace

// Rows of ``packed`` that do not start 4-byte aligned.
static bool misaligned(const void* packed, long long N4) {
  return N4 % 4 != 0 || reinterpret_cast<uintptr_t>(packed) % 4 != 0;
}

// B1: zero ``out`` (int32 [M, C]) and launch on ``stream``.  C must be a
// multiple of 128, N4 of 4, and every pointer 4-byte aligned (the caller
// checks; misaligned rows return cudaErrorInvalidValue).  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int sg_plane_dot_fwd(const void* packed, const void* d4, void* out,
                                long long M, long long N4, long long C,
                                int device, void* stream) {
  if (misaligned(packed, N4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)M * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || M == 0 || N4 == 0 || C == 0) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, plane_dot_fwd_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;

  dim3 grid((unsigned)((M + F_TB - 1) / F_TB), (unsigned)(C / TC), 1u);
  // split the byte columns so that the blocks fill the resident slots
  // about once (the slots' floor: no half-empty last wave)
  const long long tiles = (long long)grid.x * grid.y;
  const long long stages = (N4 + F_JT - 1) / F_JT;
  long long splits = (long long)per_sm * sms / tiles;
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  const long long stages_per = (stages + splits - 1) / splits;
  grid.z = (unsigned)((stages + stages_per - 1) / stages_per);
  plane_dot_fwd_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int8_t*>(d4),
      static_cast<int*>(out), (int)M, N4, (int)C, stages_per * F_JT);
  return (int)cudaGetLastError();
}

// B2: write ``out`` (int32 [4, N4, C]) on ``stream``; every element is
// written, so nothing is zeroed.  C must be a multiple of 128, N4 of 4,
// ``packed`` and ``dm`` 4-byte and ``out`` 16-byte aligned (the caller
// checks; misaligned rows return cudaErrorInvalidValue).  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int sg_plane_dot_t(const void* packed, const void* dm, void* out,
                              long long M, long long N4, long long C,
                              int device, void* stream) {
  if (misaligned(packed, N4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N4 == 0 || C == 0) return 0;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, 4 * (size_t)N4 * (size_t)C *
                                sizeof(int), s);
  dim3 grid((unsigned)((N4 + T_JW - 1) / T_JW), (unsigned)(C / TC), 1u);
  plane_dot_t_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int8_t*>(dm),
      static_cast<int*>(out), (int)M, N4, (int)C);
  return (int)cudaGetLastError();
}
