// Scan phase 1 from int8 codes on Hopper: exact integer contraction of
// every variant's genotype indicators with the sliced model vectors.
//
// Replaces saigegds_tpu/ops/pallas_score.py::_kernel (the Pallas body of
// indicator_dot).  For B variants as int8 codes [B, N] (0/1/2, 3 = missing)
// and the int8 slices vs [N, C] of the 2K+3 model vectors (|value| <= 64),
// it writes int32 out [B, 3, C]:
//   out[b, 0, c] = sum_i g0(code) * vs[i, c]   g0 = code, missing -> 0
//   out[b, 1, c] = sum_i [code == 3] * vs[i, c]
//   out[b, 2, c] = sum_i [code == 2] * vs[i, c]
// It is kernel B3 (csrc/indicator_dot_2bit.cu) at one byte per genotype and
// without the plane split.  Every product is an integer of at most
// 2 * 64 = 128, so int32 sums are exact for any N < 2^24 samples; the
// Pallas kernel's 131,072-sample f32 segments are not needed.
//
// What bounds it.  At the aggregate's main-path shape (B = 256 test
// vectors, N = 430,000 samples, C = 128) the function reads 110 MB of
// codes and 55 MB of slices, 49 us at 3.35 TB/s, and does 4.2e10
// multiply-adds (8.5e10 int8 operations, 43 us at the int8 tensor-core
// peak): balanced.  This simple form runs the multiply-adds four samples
// at a time through __dp4a on the CUDA cores, 1.06e10 dp4a, so it is bound
// by those instructions; the tensor-core form (int8 mma/wgmma with s32
// accumulation) is what would move it.
//
// Design.  A block owns TB variants x TC columns and one contiguous range
// of sample quads (four consecutive samples); ranges split the sample axis
// so enough blocks fill the card, and partial sums meet in the output
// through int32 atomicAdd (exact and order-independent).  Per stage of JT
// quads the block widens its codes once into (g0, m, g2) indicator words in
// shared memory (byte k = sample 4j + k) and transposes four sample rows of
// slice bytes into one word per column, so each thread's inner step is one
// shared load per operand and twelve dp4a.  Samples at or past N read as
// code 0 with zero slices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;                 // variants per block
constexpr int TC = 128;                // columns per block
constexpr int JT = 16;                 // sample quads per shared-memory stage
constexpr int THREADS = 256;           // 8 warps
constexpr int RB = TB / (THREADS / 32);  // variants per thread (warp-uniform)
constexpr int CQ = TC / 4;             // column quads per block (one per lane)
static_assert(CQ == 32, "one column quad per lane");

__global__ void __launch_bounds__(THREADS)
indicator_dot_kernel(const int8_t* __restrict__ codes,
                     const int8_t* __restrict__ vs, int* __restrict__ out,
                     int B, long long N, int C, long long quads_per_split) {
  // (g0, m, g2, -) indicator words: byte k = sample 4j + k (16 KB)
  __shared__ uint4 ind[JT][TB];
  // column quad q: word k holds samples 4j .. 4j+3 of column 4q+k (8 KB)
  __shared__ uint4 vsm[JT][CQ];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TC;
  const int b0 = blockIdx.y * TB;
  const long long NQ = (N + 3) / 4;
  const long long jbeg = (long long)blockIdx.z * quads_per_split;
  const long long jend = min(NQ, jbeg + quads_per_split);

  int acc[RB][4][3];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[r][k][g] = 0;

  for (long long j0 = jbeg; j0 < jend; j0 += JT) {
    // widen TB x JT code quads; codes past the range, N or B read as 0,
    // whose indicators are all zero (rows need not be 4-byte aligned, so
    // the four bytes load one at a time)
    for (int e = threadIdx.x; e < TB * JT; e += THREADS) {
      const int r = e / JT, jj = e % JT;
      const int b = b0 + r;
      const long long j = j0 + jj;
      uint32_t cw = 0u;
      if (b < B && j < jend) {
        const int8_t* src = codes + (long long)b * N + 4 * j;
        const long long left = N - 4 * j;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < left) cw |= ((uint32_t)(uint8_t)src[k] & 3u) << (8 * k);
      }
      const uint32_t m = cw & (cw >> 1) & 0x01010101u;    // code 3
      const uint32_t g2 = (cw >> 1) & ~cw & 0x01010101u;  // code 2
      const uint32_t g0 = cw - 3u * m;                    // 3 -> 0
      ind[jj][r] = make_uint4(g0, m, g2, 0u);
    }
    // stage JT quads x TC columns, transposed so that one word holds the
    // four samples of one column (dp4a's operand)
    for (int e = threadIdx.x; e < JT * CQ; e += THREADS) {
      const int jj = e / CQ, q = e % CQ;
      const long long j = j0 + jj;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (j < jend) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (4 * j + p < N)
            w[p] = *reinterpret_cast<const uint32_t*>(
                vs + (4 * j + p) * C + c0 + 4 * q);
      }
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
      vsm[jj][q] = make_uint4(__byte_perm(lo01, lo23, 0x5410),
                              __byte_perm(lo01, lo23, 0x7632),
                              __byte_perm(hi01, hi23, 0x5410),
                              __byte_perm(hi01, hi23, 0x7632));
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < JT; ++jj) {
      const uint4 v = vsm[jj][lane];
      const int vw[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const uint4 g = ind[jj][warp * RB + r];   // warp-wide broadcast
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[r][k][0] = __dp4a((int)g.x, vw[k], acc[r][k][0]);
          acc[r][k][1] = __dp4a((int)g.y, vw[k], acc[r][k][1]);
          acc[r][k][2] = __dp4a((int)g.z, vw[k], acc[r][k][2]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int b = b0 + warp * RB + r;
    if (b >= B) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int* o = out + (long long)b * 3 * C + c0 + 4 * lane + k;
      atomicAdd(o, acc[r][k][0]);
      atomicAdd(o + C, acc[r][k][1]);
      atomicAdd(o + 2 * C, acc[r][k][2]);
    }
  }
}

}  // namespace

// Zero ``out`` and launch on ``stream``.  B, N, C as above; C must be a
// multiple of 128 and ``vs`` 4-byte aligned (the caller checks).  Returns
// the CUDA error code of the launch (0 = success).
extern "C" int sg_indicator_dot(const void* codes, const void* vs, void* out,
                                long long B, long long N, long long C,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)B * 3 * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || B == 0 || N == 0 || C == 0) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  dim3 grid((unsigned)(C / TC), (unsigned)((B + TB - 1) / TB), 1u);
  // split the sample quads so that about four blocks per SM are in flight
  const long long tiles = (long long)grid.x * grid.y;
  const long long stages = ((N + 3) / 4 + JT - 1) / JT;
  long long splits = (4LL * sms + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  const long long stages_per = (stages + splits - 1) / splits;
  grid.z = (unsigned)((stages + stages_per - 1) / stages_per);
  indicator_dot_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(vs),
      static_cast<int*>(out), (int)B, N, (int)C, stages_per * JT);
  return (int)cudaGetLastError();
}
