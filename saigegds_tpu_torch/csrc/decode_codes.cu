// Sparse-stream decode on Hopper: gap-coded uint16 entries -> dense int8
// genotype codes.
//
// Replaces saigegds_tpu/ops/pallas_sparse.py::decode_codes_pallas (the XLA
// prepass _pack_stream and the gridless Pallas body _decode_kernel).  The
// input is the transport of ops/sparse_codes.py: row r owns the entries
// [row_ptr[r], row_ptr[r+1]) of ``entries``; entry (gap << 2) | code advances
// the row's cursor by gap + 1 and, when code != 0, writes code at the new
// cursor position - 1.  Escape entries (code 0) only advance the cursor;
// entries at or past row_ptr[n_rows] (stream padding) belong to no row, and
// a position outside [0, n_samples) is dropped.  The output out
// [n_rows, n_samples] is written whole, zeros included, by these kernels.
//
// What bounds it.  The function must write n_rows * n_samples output bytes
// (880 MB for a 2,048-row burden batch at N = 430,000) and read 2 bytes per
// entry (48 MB there): it is bound by the output's bytes.  The first
// version (one warp per row, a memset of the output, byte stores on top)
// wrote the output twice, with stores 16 bytes apart within a warp, and a
// row holding an entry per sample (an ALT-major variant, 430,000 entries)
// was a serial chain that set the time of the whole batch.
//
// Design: two kernels; the first splits the work evenly over the stream,
// the second over the output, and neither over rows.  The output is cut
// into flat tiles of TILE = 16 KiB (flat, not per row: every tile starts
// 16-byte aligned whatever n_samples % 16 is, and a tile may span many
// short rows).
//
// 1. table_kernel, the stream scan.  The stream [row_ptr[0], end) is cut
//    into spans of CHUNK = 4,096 entries, one block each, 16 consecutive
//    entries a thread (loaded coalesced through shared memory, so any
//    alignment of ``entries`` works).  A thread finds the row of its first
//    entry by binary search in row_ptr and walks on.  The cursor is a
//    segmented prefix sum of the advances that resets at every row start:
//    a block scans its span with warp shuffles and carries the cursor
//    across spans by decoupled look-back, in one pass.  A span publishes
//    its total at once (as a prefix when it holds a row start, since the
//    cursor after a row start does not depend on earlier spans), and one
//    warp sums its predecessors' totals 32 at a time back to the nearest
//    prefix.  Spans are handed out in launch order by a ticket, so a block
//    only waits on blocks that already run.  Two launches (span totals,
//    then a scan of them) would need a third pass over the stream.  With
//    its position known, each entry writes one uint16 word: its offset in
//    its output tile (14 bits) and its code, or 0 when it writes nothing
//    (escape, padding, a position outside its row).  And the entries write
//    the tile table: for every tile boundary b = g * TILE, the first entry
//    whose key row * n_samples + min(pos, n_samples - 1) is >= b.  Keys
//    never decrease along the stream, so tile g's entries are exactly
//    [start[g], start[g + 1]).  Every boundary is written once, with no
//    search: by the entry whose key interval (previous key, own key] holds
//    it (a row's first entry from the row's start), by a row's last entry
//    for the row's tail, and, for a row without entries, by a loop over
//    the rows (its boundaries start where the next row's entries do).  Per
//    entry the cursor and the tile test are 32-bit; the 64-bit work runs
//    only where a key crosses a boundary or a row ends.
// 2. tiles_kernel, the output-tiled replay.  One block per tile: it zeroes
//    the tile in shared memory, stores the codes of its words
//    [start[g], start[g + 1]) there, and writes the tile to the output with
//    16-byte vector stores, consecutive threads on consecutive addresses.
//    A tile without entries is stored as zeros straight from registers.
//    So every output byte is written once; only the at most 15 bytes after
//    the last whole 16-byte chunk of the output are stored as bytes, so
//    nothing lands past row n_rows - 1.
//
// Beside the output, the two kernels move 6 bytes an entry: the stream
// read, the words written and read (144 MB, 16% of the output's bytes, at
// 2,048 rows).  A scratch word per span (the look-back's status) and the
// ticket are zeroed by a memset of (spans + 1) * 8 bytes; the output is
// never memset.  Offsets are 64-bit; sums within a span are 32-bit (at
// most 4,096 * 16,384 < 2^31); a row's cursor saturates at 2^32 - 1, past
// which, as past n_samples < 2^31, every entry is dropped anyway.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;                  // consecutive entries a thread
constexpr int CHUNK = THREADS * PER;     // entries a span
constexpr int LOG_TILE = 14;
constexpr int TILE = 1 << LOG_TILE;      // output bytes a tile
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t SAT = 0xFFFFFFFFu;    // a row's cursor saturates here

static_assert(TILE % (16 * THREADS) == 0, "whole vector stores a thread");

// look-back status of a span: flag in the top two bits, value below
constexpr unsigned long long ST_AGGREGATE = 1ull << 62;
constexpr unsigned long long ST_PREFIX = 2ull << 62;
constexpr unsigned long long ST_VALUE = (1ull << 62) - 1;

// a segment of the cursor scan: f = it holds a row start, s = the advance
// after its last row start (or in all, without one)
struct Seg {
  int f;
  int s;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.s : a.s + b.s};
}

__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b) {
  return a >= SAT - b ? SAT : a + b;
}

// eight uint16 entries from a 16-byte word
__device__ __forceinline__ void unpack8(uint4 v, uint32_t* e) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[2 * i] = u[i] & 0xFFFFu;
    e[2 * i + 1] = u[i] >> 16;
  }
}

// [s0, end): the entries that belong to a row
__device__ __forceinline__ void stream_bounds(const int* __restrict__ row_ptr,
                                              long long n_entries,
                                              long long n_rows, long long& s0,
                                              long long& end) {
  s0 = max(0LL, (long long)__ldg(row_ptr));
  end = min((long long)__ldg(row_ptr + n_rows), n_entries);
  end = max(end, s0);
}

// the row r >= lo with row_ptr[r] <= k < row_ptr[r + 1]
// (row_ptr[lo] <= k < end <= row_ptr[n_rows])
__device__ __forceinline__ long long seek(const int* __restrict__ row_ptr,
                                          long long k, long long lo,
                                          long long n_rows) {
  long long hi = n_rows;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(row_ptr + mid) <= k) lo = mid; else hi = mid;
  }
  return lo;
}

// k - k0 clamped to [-1, PER + 1]: where an entry stands against the
// thread's PER entries from k0
__device__ __forceinline__ int rel(long long k, long long k0) {
  return (int)min((long long)PER + 1, max(-1LL, k - k0));
}

// a thread's view of a row: its first entry and the next row's, as rel()
struct Row {
  long long row;
  int first, next;
};

__device__ __noinline__ Row row_at(const int* __restrict__ row_ptr,
                                   long long k, long long lo,
                                   long long n_rows, long long k0) {
  long long row = lo, next = __ldg(row_ptr + lo + 1);
  if (next <= k) {                       // past row lo: empty rows between
    row = seek(row_ptr, k, lo + 1, n_rows);
    next = __ldg(row_ptr + row + 1);
  }
  return Row{row, rel(__ldg(row_ptr + row), k0), rel(next, k0)};
}

// block-wide exclusive scan of the threads' segments, and the block total
__device__ __forceinline__ void block_scan(Seg mine, Seg* warp_tot,
                                           Seg& excl, Seg& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o{__shfl_up_sync(FULL, inc.f, d), __shfl_up_sync(FULL, inc.s, d)};
    if (lane >= d) inc = combine(o, inc);
  }
  Seg ex{__shfl_up_sync(FULL, inc.f, 1), __shfl_up_sync(FULL, inc.s, 1)};
  if (lane == 0) ex = Seg{0, 0};
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  Seg before{0, 0}, all{0, 0};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before = combine(before, warp_tot[w]);
    all = combine(all, warp_tot[w]);
  }
  excl = combine(before, ex);
  total = all;
}

// Cursor before span ``span`` (warp-wide): its predecessors' totals back to
// the nearest prefix, 32 spans at a time.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, long long span) {
  const int lane = threadIdx.x & 31;
  long long acc = 0;
  for (long long j = span - 1;; j -= 32) {
    const long long idx = j - lane;
    unsigned long long w = ST_PREFIX;            // before span 0: prefix 0
    if (idx >= 0) {
      const volatile unsigned long long* p = status + idx;
      do { w = *p; } while ((w >> 62) == 0);
    }
    const unsigned pref = __ballot_sync(FULL, (w >> 62) == 2);
    const int last = pref ? __ffs(pref) - 1 : 31;
    long long v = lane <= last ? (long long)(w & ST_VALUE) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    acc += v;
    if (pref) return acc;
  }
}

// boundaries g * TILE in (lo, hi] start at entry ``start``
__device__ __forceinline__ void claim(long long* __restrict__ table,
                                      long long lo, long long hi,
                                      long long start) {
  for (long long g = (lo + TILE) >> LOG_TILE; (g << LOG_TILE) <= hi; ++g)
    table[g] = start;
}

// The table rows that entry k writes: the boundaries in (previous key,
// own key] (where its key crosses one, or it starts a row) and, for a
// row's last entry, those of the row's tail.
__device__ __noinline__ void claim_entry(long long* __restrict__ table,
                                         long long N, long long k,
                                         long long row, uint32_t pos,
                                         uint32_t before, bool last_of_row) {
  const long long base = row * N;
  const long long key = base + min((long long)pos, N - 1);
  claim(table, base + min((long long)before - 1, N - 1), key, k);
  if (last_of_row) claim(table, key, base + N - 1, k + 1);
}

__global__ void __launch_bounds__(THREADS)
table_kernel(const uint16_t* __restrict__ entries, long long n_entries,
             const int* __restrict__ row_ptr, long long n_rows,
             long long n_samples, long long n_tiles,
             long long* __restrict__ table, uint16_t* __restrict__ words,
             unsigned long long* __restrict__ status) {
  __shared__ __align__(16) uint16_t stage[CHUNK];
  __shared__ Seg warp_tot[WARPS];
  __shared__ long long sh_span, sh_carry;
  __shared__ int sh_first_is_start;

  long long s0, end;
  stream_bounds(row_ptr, n_entries, n_rows, s0, end);
  if (threadIdx.x == 0) sh_span = (long long)atomicAdd(status, 1ull);
  __syncthreads();
  const long long span = sh_span;
  const long long kc = s0 + span * CHUNK;

  // the boundaries in rows without entries start where the next row's
  // entries do; the last boundary (the output's end) at the stream's end
  const long long N = n_samples;
  for (long long r = blockIdx.x * (long long)THREADS + threadIdx.x;
       r < n_rows; r += (long long)gridDim.x * THREADS) {
    const long long a = max(s0, min((long long)__ldg(row_ptr + r), end));
    const long long b = max(s0, min((long long)__ldg(row_ptr + r + 1), end));
    if (a == b) claim(table, r * N - 1, r * N + N - 1, a);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) table[n_tiles] = end;
  if (kc >= end) return;
  const long long kend = min(kc + CHUNK, end);

  // this thread's entries: 16-byte loads where the span is aligned (a
  // tensor's own storage, row_ptr[0] % 8 == 0), else staged through shared
  // memory so that the loads of any alignment are coalesced
  const bool vec = ((reinterpret_cast<uintptr_t>(entries + kc) |
                     reinterpret_cast<uintptr_t>(words + kc)) & 15) == 0;
  const long long k0 = kc + (long long)threadIdx.x * PER;
  const int n = (int)max(0LL, min((long long)PER, kend - k0));
  uint4 raw[PER / 8];
  if (vec) {
#pragma unroll
    for (int q = 0; q < PER / 8; ++q) {
      if (8 * q + 8 <= n) {
        raw[q] = __ldg(reinterpret_cast<const uint4*>(entries + k0) + q);
      } else {
        uint32_t h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          h[i] = 8 * q + i < n ? __ldg(entries + k0 + 8 * q + i) : 0u;
        raw[q] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                            h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long k = kc + j * THREADS + threadIdx.x;
      stage[j * THREADS + threadIdx.x] = k < kend ? __ldg(entries + k) : 0;
    }
    __syncthreads();
  }
  uint32_t e[PER];
#pragma unroll
  for (int q = 0; q < PER / 8; ++q)
    unpack8(vec ? raw[q]
                : reinterpret_cast<const uint4*>(stage + threadIdx.x * PER)[q],
            e + 8 * q);

  // the thread's segment of the cursor scan
  Row r0{0, 0, 0};
  Seg seg{0, 0};
  if (n > 0) {
    r0 = row_at(row_ptr, k0, 0, n_rows, k0);
    Row r = r0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (i < n) {
        if (i >= r.next)
          r = row_at(row_ptr, k0 + i, r.row + 1, n_rows, k0);
        if (i == r.first) seg = Seg{1, 0};
        seg.s += (int)(e[i] >> 2) + 1;
      }
    }
  }
  if (threadIdx.x == 0) sh_first_is_start = r0.first == 0;
  Seg excl, total;
  block_scan(seg, warp_tot, excl, total);  // syncs: sh_first_is_start

  unsigned long long* span_status = status + 1;
  if (threadIdx.x == 0)
    *(volatile unsigned long long*)(span_status + span) =
        (total.f ? ST_PREFIX : ST_AGGREGATE) | (unsigned long long)total.s;
  if (threadIdx.x < 32) {
    long long carry = 0;
    if (!sh_first_is_start) carry = look_back(span_status, span);
    if (threadIdx.x == 0) {
      sh_carry = carry;
      if (!total.f)
        *(volatile unsigned long long*)(span_status + span) =
            ST_PREFIX | (unsigned long long)(carry + total.s);
    }
  }
  __syncthreads();

  // positions: a word for each entry, and the table's boundaries
  const uint32_t n32 = (uint32_t)n_samples;
  uint32_t w2[PER / 2] = {};            // the words, two a register
  if (n > 0) {
    Row r = r0;
    uint32_t ph = (uint32_t)((r.row * N) & (TILE - 1));
    const int end_i = rel(end, k0);
    uint32_t cur = excl.f ? (uint32_t)excl.s
                          : (uint32_t)min((long long)SAT, sh_carry + excl.s);
    // the tile of the previous entry's key (cur >= 1 unless i = 0 starts
    // a row, which resets it)
    uint32_t q_prev = (ph + TILE + min(cur, n32) - 1) >> LOG_TILE;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      uint32_t word = 0;
      if (i < n) {
        if (i >= r.next) {
          r = row_at(row_ptr, k0 + i, r.row + 1, n_rows, k0);
          ph = (uint32_t)((r.row * N) & (TILE - 1));
        }
        if (i == r.first) {
          cur = 0;
          q_prev = (ph + TILE - 1) >> LOG_TILE;
        }
        const uint32_t before = cur;
        cur = sat_add(cur, (e[i] >> 2) + 1);
        const uint32_t pos = cur - 1, code = e[i] & 3u;
        const uint32_t q = (ph + TILE + min(pos, n32 - 1)) >> LOG_TILE;
        if (code != 0 && pos < n32)
          word = (((ph + pos) & (TILE - 1)) << 2) | code;
        const bool last = i + 1 == r.next || i + 1 == end_i;
        if (q != q_prev || last)
          claim_entry(table, N, k0 + i, r.row, pos, before, last);
        q_prev = q;
      }
      w2[i / 2] |= word << (16 * (i & 1));
    }
  }
  if (vec) {
#pragma unroll
    for (int q = 0; q < PER / 8; ++q) {
      if (8 * q + 8 <= n) {
        reinterpret_cast<uint4*>(words + k0)[q] =
            make_uint4(w2[4 * q], w2[4 * q + 1], w2[4 * q + 2], w2[4 * q + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * q + i < n)
            words[k0 + 8 * q + i] = (uint16_t)(w2[4 * q + i / 2] >>
                                               (16 * (i & 1)));
      }
    }
  } else {
    // every thread read stage before block_scan's barrier
    uint4* mine = reinterpret_cast<uint4*>(stage + threadIdx.x * PER);
#pragma unroll
    for (int q = 0; q < PER / 8; ++q)
      mine[q] = make_uint4(w2[4 * q], w2[4 * q + 1], w2[4 * q + 2],
                           w2[4 * q + 3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long k = kc + j * THREADS + threadIdx.x;
      if (k < kend) words[k] = stage[j * THREADS + threadIdx.x];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tiles_kernel(const uint16_t* __restrict__ words,
             const long long* __restrict__ table, long long total,
             int8_t* __restrict__ out) {
  __shared__ __align__(16) int8_t tile[TILE];

  const long long g = blockIdx.x;
  const long long t0 = g * TILE;
  const int nbytes = (int)min((long long)TILE, total - t0);
  const int nvec = nbytes / 16;
  int4* dst = reinterpret_cast<int4*>(out + t0);
  const long long k0 = __ldg(table + g), k1 = __ldg(table + g + 1);

  if (k0 < k1) {
    int4* sv = reinterpret_cast<int4*>(tile);
    for (int i = threadIdx.x; i < TILE / 16; i += THREADS)
      sv[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    constexpr int UNROLL = 4;
    for (long long k = k0 + threadIdx.x; k < k1; k += UNROLL * THREADS) {
      uint32_t w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ku = k + u * THREADS;
        w[u] = ku < k1 ? __ldg(words + ku) : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (w[u] & 3u) tile[w[u] >> 2] = (int8_t)(w[u] & 3u);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nvec; i += THREADS) dst[i] = sv[i];
    for (int i = 16 * nvec + threadIdx.x; i < nbytes; i += THREADS)
      out[t0 + i] = tile[i];
  } else {
    for (int i = threadIdx.x; i < nvec; i += THREADS)
      dst[i] = make_int4(0, 0, 0, 0);
    for (int i = 16 * nvec + threadIdx.x; i < nbytes; i += THREADS)
      out[t0 + i] = 0;
  }
}

long long tiles_of(long long n_rows, long long n_samples) {
  return (n_rows * n_samples + TILE - 1) / TILE;
}

bool bad_shape(long long n_rows, long long n_samples) {
  return n_rows <= 0 || n_samples <= 0 || n_samples >= (1LL << 31);
}

int table_launch(const void* entries, long long n_entries,
                 const void* row_ptr, long long n_rows, long long n_samples,
                 void* table, void* words, void* status, cudaStream_t s) {
  const long long spans =
      n_entries > CHUNK ? (n_entries + CHUNK - 1) / CHUNK : 1;
  cudaError_t err = cudaMemsetAsync(status, 0, (size_t)(spans + 1) * 8, s);
  if (err != cudaSuccess) return (int)err;
  table_kernel<<<(unsigned)spans, THREADS, 0, s>>>(
      static_cast<const uint16_t*>(entries), n_entries,
      static_cast<const int*>(row_ptr), n_rows, n_samples,
      tiles_of(n_rows, n_samples), static_cast<long long*>(table),
      static_cast<uint16_t*>(words),
      static_cast<unsigned long long*>(status));
  return (int)cudaGetLastError();
}

int tiles_launch(const void* words, const void* table, long long n_rows,
                 long long n_samples, void* out, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  tiles_kernel<<<(unsigned)tiles_of(n_rows, n_samples), THREADS, 0, s>>>(
      static_cast<const uint16_t*>(words),
      static_cast<const long long*>(table), n_rows * n_samples,
      static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The kernels' constants: output bytes a tile, entries a span.
extern "C" void sg_decode_config(int* tile, int* chunk) {
  *tile = TILE;
  *chunk = CHUNK;
}

// Stage 1 on ``stream``: the tile table (int64 [tiles + 1]) and the words
// (uint16 [n_entries], defined on [row_ptr[0], row_ptr[n_rows])) of the
// stream ``entries`` (uint16 [n_entries]) and ``row_ptr`` (int32
// [n_rows + 1]).  ``status`` is scratch of (spans + 1) * 8 bytes, spans =
// max(1, ceil(n_entries / CHUNK)).  Returns the CUDA error code (0 =
// success).
extern "C" int sg_decode_table(const void* entries, long long n_entries,
                               const void* row_ptr, long long n_rows,
                               long long n_samples, void* table, void* words,
                               void* status, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n_rows, n_samples)) return (int)cudaErrorInvalidValue;
  return table_launch(entries, n_entries, row_ptr, n_rows, n_samples, table,
                      words, status, reinterpret_cast<cudaStream_t>(stream));
}

// Stage 2 on ``stream``: every byte of ``out`` [n_rows, n_samples] (16-byte
// aligned) from the words and the tile table of stage 1.
extern "C" int sg_decode_tiles(const void* words, const void* table,
                               long long n_rows, long long n_samples,
                               void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n_rows, n_samples)) return (int)cudaErrorInvalidValue;
  return tiles_launch(words, table, n_rows, n_samples, out,
                      reinterpret_cast<cudaStream_t>(stream));
}

// Both stages on ``stream`` from one call (what decode_codes launches).
extern "C" int sg_decode_codes(const void* entries, long long n_entries,
                               const void* row_ptr, long long n_rows,
                               long long n_samples, void* table, void* words,
                               void* status, void* out, int device,
                               void* stream) {
  const int err = sg_decode_table(entries, n_entries, row_ptr, n_rows,
                                  n_samples, table, words, status, device,
                                  stream);
  if (err != 0) return err;
  return tiles_launch(words, table, n_rows, n_samples, out,
                      reinterpret_cast<cudaStream_t>(stream));
}
