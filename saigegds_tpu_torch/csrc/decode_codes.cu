// Sparse-stream decode on Hopper: gap-coded uint16 entries -> dense int8
// genotype codes.
//
// Replaces saigegds_tpu/ops/pallas_sparse.py::decode_codes_pallas (the XLA
// prepass _pack_stream and the gridless Pallas body _decode_kernel).  The
// input is the transport of ops/sparse_codes.py: row r owns the entries
// [row_ptr[r], row_ptr[r+1]) of ``entries``; entry (gap << 2) | code advances
// the row's cursor by gap + 1 and, when code != 0, writes code at the new
// cursor position - 1.  Escape entries (code 0) only advance the cursor;
// entries at or past row_ptr[n_rows] (stream padding) belong to no row.
// The output out [n_rows, n_samples] is zeroed first, here.
//
// What bounds it.  The function must write n_rows * n_samples output bytes
// (880 MB for a 2,048-row burden batch at N = 430,000) and read 2 bytes per
// entry, so it is bound by memory; the zeroing is that write, and the
// scattered code stores touch one 32-byte sector per nonzero on top.
//
// Design.  The TPU kernel needed one global segmented scan because its
// kernel was gridless.  Here rows are independent (row_ptr gives each its
// start), so one warp decodes one row: per step each lane takes sixteen
// consecutive entries, the warp takes an inclusive prefix sum of their
// cursor advances (__shfl_up_sync), carries the row's running cursor from
// step to step, and stores each nonzero code at its position.  A row of
// one entry costs one warp-step; eight rows share a block.  A row is a
// serial chain of steps, so the longest row sets the time (an ALT-major
// row holds an entry per sample): each step loads the next step's entries
// before it scans its own, so the load latency overlaps the scan instead
// of adding to every step.  Output offsets are 64-bit, so any
// n_rows * n_samples the encoder takes (< 2^31) or more fits; a position
// outside its row is dropped rather than written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                 // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int PER_LANE = 16;             // entries per lane per step
constexpr int STEP = 32 * PER_LANE;      // entries per warp per step
constexpr unsigned FULL = 0xFFFFFFFFu;

// this lane's PER_LANE entries of the step at k0 (0 past the row's end)
__device__ __forceinline__ void load_step(const uint16_t* __restrict__ entries,
                                          long long k0, long long end,
                                          int lane, uint32_t (&e)[PER_LANE]) {
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const long long k = k0 + lane * PER_LANE + i;
    e[i] = k < end ? (uint32_t)__ldg(entries + k) : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
decode_codes_kernel(const uint16_t* __restrict__ entries,
                    const int* __restrict__ row_ptr,
                    int8_t* __restrict__ out, long long n_rows,
                    long long n_samples) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;             // whole warps leave together
  const long long beg = row_ptr[row];
  const long long end = row_ptr[row + 1];
  int8_t* dst = out + row * n_samples;

  uint32_t next[PER_LANE];
  load_step(entries, beg, end, lane, next);
  long long carry = 0;                   // cursor after the previous steps
  for (long long k0 = beg; k0 < end; k0 += STEP) {
    uint32_t e[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) e[i] = next[i];
    load_step(entries, k0 + STEP, end, lane, next);   // in flight meanwhile
    int incl[PER_LANE];                  // lane-local inclusive advances
    int s = 0;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      s += k0 + lane * PER_LANE + i < end ? (int)(e[i] >> 2) + 1 : 0;
      incl[i] = s;
    }
    // inclusive scan of the lanes' totals (each <= 16 * 16384)
    int t = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += v;
    }
    const long long before = carry + (t - s);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const long long pos = before + incl[i] - 1;
      const int code = (int)(e[i] & 3u);
      if (code != 0 && pos >= 0 && pos < n_samples) dst[pos] = (int8_t)code;
    }
    carry += __shfl_sync(FULL, t, 31);
  }
}

}  // namespace

// Zero ``out`` [n_rows, n_samples] and decode the stream into it on
// ``stream``.  ``entries`` is uint16 [row_ptr[n_rows] or more], ``row_ptr``
// int32 [n_rows + 1] with row_ptr[0] == 0.  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int sg_decode_codes(const void* entries, const void* row_ptr,
                               void* out, long long n_rows,
                               long long n_samples, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)n_rows * (size_t)n_samples, s);
  if (err != cudaSuccess || n_rows == 0 || n_samples == 0) return (int)err;
  const long long blocks = (n_rows + WARPS - 1) / WARPS;
  decode_codes_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const uint16_t*>(entries), static_cast<const int*>(row_ptr),
      static_cast<int8_t*>(out), n_rows, n_samples);
  return (int)cudaGetLastError();
}
