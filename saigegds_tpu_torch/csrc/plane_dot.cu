// The two passes of the 2-bit GRM matvec on Hopper: fused planar 2-bit
// decode + exact integer contraction against signed-7-bit slices.
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
// 2 * 64 = 128, so int32 sums are exact for N < 2^24 samples (B1) and for
// M < 2^24 variants (B2); the Pallas kernels' 2^17-sample and
// 131,072-variant segments existed only for their f32 accumulators.
//
// What bounds them.  At the fit's main-path shape (M = 16,384 variants,
// N = 430,000 samples, C = 128 columns) each pass reads 1.76 GB of packed
// codes (0.5 ms of HBM traffic) and executes M * N4 * C = 2.25e11 __dp4a
// (four samples or four variants per instruction): both are bound by
// integer issue, not by memory.  The tensor-core form (int8 mma/wgmma with
// s32 accumulation, fed by TMA) is what moves that bound.
//
// B1 design (B3, csrc/indicator_dot_2bit.cu, with one indicator instead of
// three).  A block owns TB variants x TC columns and one contiguous range
// of byte columns; ranges split the sample axis so that enough blocks fill
// the card, and partial sums meet in the output through int32 atomicAdd
// (exact and order-independent).  Per stage of JT byte columns the block
// spreads each packed byte once into a word whose byte p is plane p's code,
// and transposes the four planes' slice bytes of each column into one word,
// so a __dp4a takes four samples.  A thread holds RB variants x 4 columns
// and reads four stages' codes of a variant in one 16-byte shared load.
//
// B2 design.  The contraction runs over variants, so a __dp4a takes four
// variants of one plane: the staging transposes the other way from B1 --
// four rows of packed bytes become four plane words, four rows of dm
// become one word per column.  A block owns JW byte columns (4 * JW output
// rows) x TC columns and loops over all M by itself: with N4 / JW blocks
// (3,360 at N = 430,000) the card is full without splitting M, so there
// are no atomics and the result is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TC = 128;                     // columns per block
constexpr int CQ = TC / 4;                  // column quads (one per lane)
static_assert(CQ == 32, "one column quad per lane");

// B1 tiling
constexpr int F_TB = 64;                    // variants per block
constexpr int F_JT = 16;                    // byte columns per stage
constexpr int F_RB = F_TB / WARPS;          // variants per thread
static_assert(F_JT % 4 == 0, "16-byte code loads");

// B2 tiling
constexpr int T_JW = 32;                    // byte columns per block
constexpr int T_MQ = 16;                    // variant quads per stage
constexpr int T_JPW = T_JW / WARPS;         // byte columns per warp

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

__global__ void __launch_bounds__(THREADS)
plane_dot_fwd_kernel(const uint8_t* __restrict__ packed,
                     const int8_t* __restrict__ d4, int* __restrict__ out,
                     int M, long long N4, int C, long long cols_per_split) {
  // row r: spread planes of the stage's JT packed bytes of variant m0 + r
  __shared__ __align__(16) uint32_t ind[F_TB][F_JT];      // 4 KB
  // column quad q: word k holds planes 0..3 of column 4q + k
  __shared__ uint4 vsm[F_JT][CQ];                          // 8 KB

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * F_TB;
  const int c0 = blockIdx.y * TC;
  const long long jbeg = (long long)blockIdx.z * cols_per_split;
  const long long jend = min(N4, jbeg + cols_per_split);

  int acc[F_RB][4];
#pragma unroll
  for (int r = 0; r < F_RB; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0;

  for (long long j0 = jbeg; j0 < jend; j0 += F_JT) {
    // bytes past the range or past M read as code 0 (contributes nothing)
    for (int e = threadIdx.x; e < F_TB * F_JT; e += THREADS) {
      const int r = e / F_JT, jj = e % F_JT;
      const int m = m0 + r;
      const long long j = j0 + jj;
      const uint32_t x =
          (m < M && j < jend) ? (uint32_t)packed[(long long)m * N4 + j] : 0u;
      ind[r][jj] = spread_planes(x);
    }
    for (int e = threadIdx.x; e < F_JT * CQ; e += THREADS) {
      const int jj = e / CQ, q = e % CQ;
      const long long j = j0 + jj;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (j < jend) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          w[p] = *reinterpret_cast<const uint32_t*>(
              d4 + ((long long)p * N4 + j) * C + c0 + 4 * q);
      }
      vsm[jj][q] = transpose4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

#pragma unroll
    for (int jq = 0; jq < F_JT; jq += 4) {
      int vw[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 v = vsm[jq + u][lane];
        vw[u][0] = (int)v.x; vw[u][1] = (int)v.y;
        vw[u][2] = (int)v.z; vw[u][3] = (int)v.w;
      }
#pragma unroll
      for (int r = 0; r < F_RB; ++r) {
        // four stages' codes of one variant: a warp-wide broadcast
        const uint4 g =
            *reinterpret_cast<const uint4*>(&ind[warp * F_RB + r][jq]);
        const int gw[4] = {(int)g.x, (int)g.y, (int)g.z, (int)g.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[r][k] = __dp4a(gw[u], vw[u][k], acc[r][k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < F_RB; ++r) {
    const int m = m0 + warp * F_RB + r;
    if (m >= M) break;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(out + (long long)m * C + c0 + 4 * lane + k, acc[r][k]);
  }
}

__global__ void __launch_bounds__(THREADS)
plane_dot_t_kernel(const uint8_t* __restrict__ packed,
                   const int8_t* __restrict__ dm, int* __restrict__ out,
                   int M, long long N4, int C) {
  // (quad q, byte column jj): word p holds plane p's codes of variants
  // mb + 4q .. mb + 4q + 3
  __shared__ uint4 ind[T_MQ][T_JW];                         // 8 KB
  // (quad q, column quad cq): word k holds dm[mb + 4q .. +3, 4 cq + k]
  __shared__ uint4 dsm[T_MQ][CQ];                           // 8 KB

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long jb = (long long)blockIdx.x * T_JW;
  const int c0 = blockIdx.y * TC;

  int acc[T_JPW][4][4];                 // [byte column][plane][column]
#pragma unroll
  for (int a = 0; a < T_JPW; ++a)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[a][p][k] = 0;

  for (int mb = 0; mb < M; mb += 4 * T_MQ) {
    // rows past M and byte columns past N4 read as code 0
    for (int e = threadIdx.x; e < T_MQ * T_JW; e += THREADS) {
      const int q = e / T_JW, jj = e % T_JW;
      const long long j = jb + jj;
      const int m = mb + 4 * q;
      uint32_t x = 0u;
      if (j < N4) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (m + k < M)
            x |= (uint32_t)packed[(long long)(m + k) * N4 + j] << (8 * k);
      }
      ind[q][jj] = make_uint4(x & 0x03030303u, (x >> 2) & 0x03030303u,
                              (x >> 4) & 0x03030303u, (x >> 6) & 0x03030303u);
    }
    for (int e = threadIdx.x; e < T_MQ * CQ; e += THREADS) {
      const int q = e / CQ, cq = e % CQ;
      const int m = mb + 4 * q;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (m + k < M)
          w[k] = *reinterpret_cast<const uint32_t*>(
              dm + (long long)(m + k) * C + c0 + 4 * cq);
      dsm[q][cq] = transpose4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int q = 0; q < T_MQ; ++q) {
      const uint4 v = dsm[q][lane];
      const int vw[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
#pragma unroll
      for (int a = 0; a < T_JPW; ++a) {
        const uint4 g = ind[q][warp * T_JPW + a];   // warp-wide broadcast
        const int gw[4] = {(int)g.x, (int)g.y, (int)g.z, (int)g.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[a][p][k] = __dp4a(gw[p], vw[k], acc[a][p][k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < T_JPW; ++a) {
    const long long j = jb + warp * T_JPW + a;
    if (j >= N4) break;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<int4*>(out + ((long long)p * N4 + j) * C + c0 +
                               4 * lane) =
          make_int4(acc[a][p][0], acc[a][p][1], acc[a][p][2], acc[a][p][3]);
  }
}

}  // namespace

// B1: zero ``out`` (int32 [M, C]) and launch on ``stream``.  C must be a
// multiple of 128 and every pointer 4-byte aligned (the caller checks).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int sg_plane_dot_fwd(const void* packed, const void* d4, void* out,
                                long long M, long long N4, long long C,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)M * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || M == 0 || N4 == 0 || C == 0) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  dim3 grid((unsigned)((M + F_TB - 1) / F_TB), (unsigned)(C / TC), 1u);
  // split the byte columns so that about four blocks per SM are in flight
  const long long tiles = (long long)grid.x * grid.y;
  const long long stages = (N4 + F_JT - 1) / F_JT;
  long long splits = (4LL * sms + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  const long long stages_per = (stages + splits - 1) / splits;
  grid.z = (unsigned)((stages + stages_per - 1) / stages_per);
  plane_dot_fwd_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int8_t*>(d4),
      static_cast<int*>(out), (int)M, N4, (int)C, stages_per * F_JT);
  return (int)cudaGetLastError();
}

// B2: write ``out`` (int32 [4, N4, C]) on ``stream``; every element is
// written, so nothing is zeroed.  C must be a multiple of 128, ``dm`` 4-byte
// and ``out`` 16-byte aligned (the caller checks).  Returns the CUDA error
// code of the launch (0 = success).
extern "C" int sg_plane_dot_t(const void* packed, const void* dm, void* out,
                              long long M, long long N4, long long C,
                              int device, void* stream) {
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
