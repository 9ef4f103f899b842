// Sample gather of planar 2-bit code blocks on Hopper.
//
// Replaces no TPU kernel.  The JAX package gathers a block of genotype
// codes to the models' samples on the host (or scans such models on its
// dense route), and a host gather (``np.take``) costs about five times the
// 2-bit pack that follows it.  The port's 2-bit scan ships each block packed
// over all of its GDS samples and gathers it here, on the card, after the
// upload, into exactly the payload that
// ``ops/packed_grm.pack_codes_2bit(np.take(G, cols, axis=1))`` gives, so
// kernel B3 and everything after it see the same bytes.
//
// Layout (ops/packed_grm.pack_codes_2bit).  Input row r holds n4_in bytes;
// byte j holds GDS samples j, n4_in + j, 2 n4_in + j and 3 n4_in + j in bit
// pairs 0/2/4/6.  Output row r holds n4_out = ceil(n_cols / 4) bytes; byte
// k holds model columns k, n4_out + k, 2 n4_out + k and 3 n4_out + k, column
// m's code read from byte cols[m] % n4_in of the input row, in plane
// cols[m] / n4_in.  Bit pairs of columns at or past n_cols are 0.  A column
// outside the input row (cols[m] < 0 or >= 4 n4_in) reads 0; the wrapper's
// plain version raises there.
//
// What bounds it: bytes.  At the scan's shape (1,024 rows, 488,000 GDS
// samples gathered to 430,000) it reads 125 MB of codes and 1.7 MB of
// indices and writes 110 MB: 0.07 ms at 3.35 TB/s.  No arithmetic to speak
// of, so no tensor cores, TMA or shared memory.
//
// Design: a block owns THREADS consecutive output bytes of every row of a
// chunk of ROWS rows.  A thread finds the sources of its output byte once
// (four loads of ``cols``, four divisions) and then walks the rows: four
// byte loads and one byte store a row.  Consecutive threads store
// consecutive bytes, one 32-byte sector a warp and row; ``cols`` is sorted
// in the scan, so a warp's loads of one plane fall on about 36 consecutive
// input bytes, two sectors.  The row loop is unrolled so that the loads of
// several rows are in flight at once.  Offsets are 64-bit.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // output bytes of a block
constexpr int ROWS = 16;       // rows of a block
constexpr long long MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
gather_2bit_kernel(const uint8_t* __restrict__ in,
                   const int32_t* __restrict__ cols,
                   uint8_t* __restrict__ out, long long n_rows,
                   long long n4_in, long long n_cols, long long n4_out) {
  const long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (k >= n4_out) return;
  // the sources of output byte k: input byte, shift and mask a plane
  long long src[4];
  int shift[4];
  unsigned mask[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long m = p * n4_out + k;
    const long long c = m < n_cols ? (long long)__ldg(cols + m) : -1;
    const bool in_row = c >= 0 && c < 4 * n4_in;
    const long long plane = in_row ? c / n4_in : 0;
    src[p] = in_row ? c - plane * n4_in : 0;
    shift[p] = 2 * (int)plane;
    mask[p] = in_row ? 3u : 0u;
  }
  for (long long r0 = blockIdx.y * (long long)ROWS; r0 < n_rows;
       r0 += (long long)gridDim.y * ROWS) {
    const int rows = (int)min((long long)ROWS, n_rows - r0);
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const uint8_t* row = in + (r0 + i) * n4_in;
      unsigned b = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        b |= (((unsigned)__ldg(row + src[p]) >> shift[p]) & mask[p])
             << (2 * p);
      out[(r0 + i) * n4_out + k] = (uint8_t)b;
    }
  }
}

}  // namespace

// The gather of ``in`` (uint8 [n_rows, n4_in], planar 2-bit) to the columns
// ``cols`` (int32 [n_cols]) into ``out`` (uint8 [n_rows, ceil(n_cols / 4)],
// every byte written), on ``stream``.  Returns the CUDA error code (0 =
// success).
extern "C" int sg_gather_2bit(const void* in, const void* cols, void* out,
                              long long n_rows, long long n4_in,
                              long long n_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || n_cols <= 0 || n4_in <= 0 || n_cols >= (1LL << 31) ||
      4 * n4_in >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long n4_out = (n_cols + 3) / 4;
  const long long chunks = (n_rows + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)((n4_out + THREADS - 1) / THREADS),
                  (unsigned)std::min(chunks, MAX_GRID_Y));
  gather_2bit_kernel<<<grid, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<const int32_t*>(cols),
      static_cast<uint8_t*>(out), n_rows, n4_in, n_cols, n4_out);
  return (int)cudaGetLastError();
}
