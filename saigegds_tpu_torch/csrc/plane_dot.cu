// The two passes of the 2-bit GRM matvec on Hopper: fused planar 2-bit
// decode + exact integer contraction against signed-7-bit slices on the
// int8 tensor cores, through the warpgroup MMA (wgmma) with operand tiles
// brought in by TMA; and the slice decomposition that makes their f64
// operands into those slices (slice_colmax_kernel, slice_i8_kernel below).
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
// d4 and dm are int8 slices with |value| <= 64 (zero at padded samples and
// columns).  Every product is an integer of at most 2 * 64 = 128, so s32
// sums are exact for N < 2^24 samples (B1) and for M < 2^24 variants (B2);
// the Pallas kernels' 2^17-sample and 131,072-variant segments existed only
// for their f32 accumulators.  A tensor map needs every row of the store to
// start 16-byte aligned (N4 % 16 == 0 and an aligned base); the port's GRM
// store pads N4 so (ops/packed_grm.py store_width), and the entry points
// refuse other stores.
//
// What bounds them.  At the fit's main-path shape (M = 16,384 variants,
// N = 430,000 samples, N4 = 107,504) each pass reads 1.76 GB of packed
// codes once (0.53 ms at 3.35 TB/s) and does 2 * M * 4 N4 * C int8
// operations: 1.8e12 at C = 128 (0.91 ms at the dense int8 tensor-core
// peak of 1,979 TOP/s, a rate that only wgmma reaches), so from C = 64 up
// they are bound by the tensor cores and below it by the store's bytes.
// The slices are small (d4 55 MB, dm 2 MB at C = 128) but every block
// reads its column tile of them again from L2: d4 once per 256 variants
// (3.5 GB at C = 128), dm once per 64 byte columns (3.5 GB).
//
// The design.  A block is one producer warpgroup and two consumer
// warpgroups, one block per SM.  One thread of the producer keeps a ring of
// up to 8 stages in shared memory filled by TMA, each stage completing its
// bytes on a "full" mbarrier; the consumers release a stage on its "empty"
// mbarrier (one arrival per consumer warp) once their MMAs have read it,
// so the copies run ahead of the tensor cores by the depth of the ring.
// setmaxnreg gives the producer's registers to the consumers.  A stage's
// slice tile is BN rows of 128 bytes of k, K-major, written with the
// 128-byte swizzle that the wgmma descriptor names, and the tensor cores
// read it straight from shared memory.  Integer wgmma reads shared operands
// K-major only, and the packed codes must be decoded anyway, so A comes from
// registers: each consumer thread reads its rows' packed bytes from the
// staged tile (bank-conflict free) and turns them into the m64nNk32 A
// fragment on the CUDA cores.  A consumer warpgroup owns MT m64 tiles
// (MT = 2, or 1 at BN = 256), builds the stage's A fragments, then starts
// all of the stage's MMAs, commits and waits; the two warpgroups interleave
// on the tensor cores.  The column tile BN (wgmma's n) is a template
// parameter, 16, 32, 64, 128 or 256, so a product of one right-hand side
// (8 slice columns) runs at BN = 16 and is bound by the store's bytes;
// wider C loops over tiles of 128 or 256.  Left open: multicast of the
// slice tiles to the blocks of a cluster (the L2 re-reads above) and a
// persistent grid.
//
// B1.  k runs over (byte column j, plane p), a stage being 32 byte columns
// (128 k).  Thread t of a quad reads 8 packed bytes of each of its rows (at
// byte column 8t of the stage) and turns each word of four bytes into four
// A words, one per byte column, holding its four planes (plane masks, then
// a 4 x 4 byte transpose).  Byte column 8t + 2s + h of the stage feeds
// k-step s, half h (the fragment's k 16h + 4t .. +3), so the wrapper hands
// the slices over in that order, d4k [C, 4 N4p] (N4p = N4 rounded up to
// 32; laid out from the slices' sample rows by fwd_rows_layout_kernel
// below, one transpose through shared memory; ops/grm_kernel.py
// fwd_rows_operand): byte 32s + 16h + 4t + p of
// each 128-byte group G of column c is d4[p, 32G + 8t + 2s + h, c].  A
// block owns 256 variants (128 at BN = 256) x BN columns x one split of the
// byte columns; the splits fill the card once and their partial sums meet
// in the output through int32 atomicAdd (exact and order-independent).
//
// B2.  The output rows are (plane p, byte column j) and k is the variant, a
// stage being 128 variants.  Row g of warp w is byte column 4g + w of a
// 32-column sub-tile, at one plane, row g + 8 the next plane.  For each
// half h of a k-step thread t reads one byte of each of variants t, 4 + t,
// 8 + t, 12 + t of the 16-variant group (bank-conflict free: the 32 lanes
// hit 32 banks) and masks out a plane: the A word of k 16h + 4t + i is
// variant 16h + 4i + t.  So the operand is laid out as dmt [C, M16] (M16 =
// M rounded up to 16; ops/grm_kernel.py t_operand): byte 16G + 4t + i of
// column c is dm[16G + 4i + t, c].  With MT = 2 a consumer warpgroup covers
// all four planes of its own 32 byte columns (64 per block); with MT = 1
// both cover the same 32 columns, two planes each.  A block walks all of M
// by itself: no atomics, and the result is deterministic.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

namespace wg = wgmma_s8;
using wg::encode;
using wg::misaligned;

constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int EMPTY_ARRIVALS = 4 * CONSUMERS;   // one per consumer warp
constexpr int KB = 128;        // bytes of k per stage row of the slices
constexpr int F_JS = KB / 4;   // B1: byte columns per stage
constexpr int T_VS = KB;       // B2: variants per stage
constexpr int T_JS = 32;       // B2: byte columns of a packed sub-tile
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200 * 1024;          // the ring's shared memory
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536,
              "the block's registers fit the SM");
constexpr uint32_t LOW2 = 0x03030303u;          // one 2-bit code per byte

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

// Stages of ``bytes`` each that the ring holds, at most MAX_STAGES.
constexpr int ring_stages(int bytes) {
  return RING_BYTES / bytes < MAX_STAGES ? RING_BYTES / bytes : MAX_STAGES;
}

template <int BN>
struct Tile {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128 || BN == 256,
                "wgmma n of the instantiated column tiles");
  static constexpr int MT = BN == 256 ? 1 : 2;   // m64 tiles per warpgroup
  static constexpr int BM = 64 * MT * CONSUMERS; // B1: variants per block
  static constexpr int JB = T_JS * MT;           // B2: byte columns per block
  static constexpr int B_BYTES = KB * BN;        // a stage's slice box
  static constexpr int F_A_BYTES = BM * F_JS;    // B1: the packed box
  static constexpr int T_A_BYTES = T_VS * JB;    // B2: MT packed boxes
  static constexpr int F_STAGES = ring_stages(B_BYTES + F_A_BYTES);
  static constexpr int T_STAGES = ring_stages(B_BYTES + T_A_BYTES);
  static_assert(F_STAGES >= 3 && T_STAGES >= 3, "a ring of 3 stages at least");
  static_assert(B_BYTES % 1024 == 0 && F_A_BYTES % 1024 == 0 &&
                T_A_BYTES % 1024 == 0, "boxes keep the 1,024-byte alignment");
  static constexpr int smem_bytes(int stages, int a_bytes) {
    return stages * (B_BYTES + a_bytes) + 2 * stages * 8 + 1024;
  }
};

// The ring in dynamic shared memory, aligned to 1,024 bytes: the stages'
// slice tiles, then their packed tiles, then the full and empty barriers.
struct Ring {
  uint8_t* b;
  uint8_t* a;
  uint64_t* full;
  uint64_t* empty;
};

template <int STAGES>
__device__ __forceinline__ Ring ring(uint8_t* raw, int b_bytes, int a_bytes) {
  const uint32_t at = wg::smem_u32(raw);
  uint8_t* base = raw + (((at + 1023u) & ~1023u) - at);
  Ring r;
  r.b = base;
  r.a = base + STAGES * b_bytes;
  r.full = reinterpret_cast<uint64_t*>(r.a + STAGES * a_bytes);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&r.full[s], 1);
      wg::mbar_init(&r.empty[s], EMPTY_ARRIVALS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// B1: a block owns BM variants x BN columns x byte-column groups
// [g_begin, g_begin + n) of 32 byte columns each.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
plane_dot_fwd_kernel(const __grid_constant__ CUtensorMap tm_packed,
                     const __grid_constant__ CUtensorMap tm_slices,
                     int* __restrict__ out, int M, int C, int n_groups,
                     int groups_per_split) {
  using T = Tile<BN>;
  constexpr int S = T::F_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring<S>(smem_raw, T::B_BYTES, T::F_A_BYTES);
  const int g_begin = blockIdx.z * groups_per_split;
  const int n = min(n_groups - g_begin, groups_per_split);   // >= 1
  const int m0 = blockIdx.x * T::BM;
  const int c0 = blockIdx.y * BN;
  const int wgi = threadIdx.x / 128;

  if (wgi == CONSUMERS) {                  // the producer
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      wg::tma_prefetch_map(&tm_packed);
      wg::tma_prefetch_map(&tm_slices);
      for (int it = 0, s = 0, ph = 0; it < n; ++it) {
        wg::mbar_wait(&r.empty[s], ph ^ 1);
        wg::mbar_expect_tx(&r.full[s], T::B_BYTES + T::F_A_BYTES);
        wg::tma_load_2d(r.b + s * T::B_BYTES, &tm_slices, &r.full[s],
                        KB * (g_begin + it), c0);
        wg::tma_load_2d(r.a + s * T::F_A_BYTES, &tm_packed, &r.full[s],
                        F_JS * (g_begin + it), m0);
        if (++s == S) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  int acc[T::MT][BN / 2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0;

  for (int it = 0, s = 0, ph = 0; it < n; ++it) {
    wg::mbar_wait(&r.full[s], ph);
    // A fragments of the stage's 4 k-steps: [k-step][tile][register], from
    // a row's 8 bytes at byte column 8t
    const uint8_t* pa = r.a + s * T::F_A_BYTES;
    uint32_t a[4][T::MT][4];
#pragma unroll
    for (int ti = 0; ti < T::MT; ++ti)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = 64 * (wgi * T::MT + ti) + 16 * warp + 8 * rh + g;
        const uint2 w =
            *reinterpret_cast<const uint2*>(pa + row * F_JS + 8 * t);
#pragma unroll
        for (int wi = 0; wi < 2; ++wi) {
          const uint32_t x = wi ? w.y : w.x;
          // word k: the four planes of byte column 8t + 4wi + k
          const uint4 q = transpose4(x & LOW2, (x >> 2) & LOW2,
                                     (x >> 4) & LOW2, (x >> 6) & LOW2);
          a[2 * wi][ti][rh] = q.x;
          a[2 * wi][ti][rh + 2] = q.y;
          a[2 * wi + 1][ti][rh] = q.z;
          a[2 * wi + 1][ti][rh + 2] = q.w;
        }
      }
#pragma unroll
    for (int ti = 0; ti < T::MT; ++ti) wg::fence_operand(acc[ti]);
    wg::fence();
    const uint64_t desc = wg::desc_sw128(wg::smem_u32(r.b + s * T::B_BYTES));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int ti = 0; ti < T::MT; ++ti)
        wg::mma(acc[ti], a[ks][ti], desc + 2 * ks);
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int ti = 0; ti < T::MT; ++ti) wg::fence_operand(acc[ti]);
    if (lane == 0) wg::mbar_arrive(&r.empty[s]);
    if (++s == S) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int ti = 0; ti < T::MT; ++ti)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int m = m0 + 64 * (wgi * T::MT + ti) + 16 * warp + 8 * rh + g;
      if (m >= M) continue;
      int* o = out + (long long)m * C + c0 + 2 * t;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        atomicAdd(o + 8 * q, acc[ti][4 * q + 2 * rh]);
        atomicAdd(o + 8 * q + 1, acc[ti][4 * q + 2 * rh + 1]);
      }
    }
}

// B2: a block owns JB byte columns (4 JB output rows) x BN columns and
// walks all variants.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
plane_dot_t_kernel(const __grid_constant__ CUtensorMap tm_packed,
                   const __grid_constant__ CUtensorMap tm_operand,
                   int* __restrict__ out, long long N4, int C, int n_stages) {
  using T = Tile<BN>;
  constexpr int S = T::T_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring<S>(smem_raw, T::B_BYTES, T::T_A_BYTES);
  const int jb = blockIdx.x * T::JB;
  const int c0 = blockIdx.y * BN;
  const int wgi = threadIdx.x / 128;

  if (wgi == CONSUMERS) {                  // the producer
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      wg::tma_prefetch_map(&tm_packed);
      wg::tma_prefetch_map(&tm_operand);
      for (int it = 0, s = 0, ph = 0; it < n_stages; ++it) {
        wg::mbar_wait(&r.empty[s], ph ^ 1);
        wg::mbar_expect_tx(&r.full[s], T::B_BYTES + T::T_A_BYTES);
        wg::tma_load_2d(r.b + s * T::B_BYTES, &tm_operand, &r.full[s],
                        T_VS * it, c0);
#pragma unroll
        for (int sub = 0; sub < T::MT; ++sub)
          wg::tma_load_2d(r.a + s * T::T_A_BYTES + sub * T_VS * T_JS,
                          &tm_packed, &r.full[s], jb + T_JS * sub, T_VS * it);
        if (++s == S) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // the warpgroup's packed sub-tile and first plane (see the header)
  const int sub = wgi * T::MT / 2;
  const int plane0 = (wgi * 2 * T::MT) % 4;
  const int jj = T_JS * sub + 4 * g + warp;     // byte column in the block
  int acc[T::MT][BN / 2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0;

  for (int it = 0, s = 0, ph = 0; it < n_stages; ++it) {
    wg::mbar_wait(&r.full[s], ph);
    const uint8_t* pa = r.a + s * T::T_A_BYTES + sub * T_VS * T_JS +
                        t * T_JS + 4 * g + warp;
    uint32_t a[4][T::MT][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t v[2];       // byte i: variant 32 ks + 16 h + 4 i + t
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* p = pa + (32 * ks + 16 * h) * T_JS;
        v[h] = (uint32_t)p[0] | ((uint32_t)p[4 * T_JS] << 8) |
               ((uint32_t)p[8 * T_JS] << 16) | ((uint32_t)p[12 * T_JS] << 24);
      }
#pragma unroll
      for (int ti = 0; ti < T::MT; ++ti) {
        const int pl = plane0 + 2 * ti;
        a[ks][ti][0] = (v[0] >> (2 * pl)) & LOW2;
        a[ks][ti][1] = (v[0] >> (2 * pl + 2)) & LOW2;
        a[ks][ti][2] = (v[1] >> (2 * pl)) & LOW2;
        a[ks][ti][3] = (v[1] >> (2 * pl + 2)) & LOW2;
      }
    }
#pragma unroll
    for (int ti = 0; ti < T::MT; ++ti) wg::fence_operand(acc[ti]);
    wg::fence();
    const uint64_t desc =
        wg::desc_sw128(wg::smem_u32(r.b + s * T::B_BYTES));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int ti = 0; ti < T::MT; ++ti)
        wg::mma(acc[ti], a[ks][ti], desc + 2 * ks);
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int ti = 0; ti < T::MT; ++ti) wg::fence_operand(acc[ti]);
    if (lane == 0) wg::mbar_arrive(&r.empty[s]);
    if (++s == S) { s = 0; ph ^= 1; }
  }

  const long long j = (long long)jb + jj;
  if (j >= N4) return;
#pragma unroll
  for (int ti = 0; ti < T::MT; ++ti)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int p = plane0 + 2 * ti + rh;
      int* o = out + ((long long)p * N4 + j) * C + c0 + 2 * t;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
        *reinterpret_cast<int2*>(o + 8 * q) =
            make_int2(acc[ti][4 * q + 2 * rh], acc[ti][4 * q + 2 * rh + 1]);
    }
}

// B1's operand from the slices' sample rows: rows int8 [n, rs] (row
// p N4 + j is byte column j of plane p) -> d4k int8 [C, 4 N4p] in the
// kernel's k order (see the header), zero at positions of no sample and at
// columns c >= rs.  A block transposes one 128-byte group G of d4k for
// up to LAYOUT_COLS columns (C < 64: all C) through shared memory: it
// reads the group's 4 x 32 rows (bytes of a row consecutive across
// threads) and writes each column's 128 bytes consecutively.
constexpr int LAYOUT_COLS = 64;
constexpr int LAYOUT_THREADS = 256;

__global__ void __launch_bounds__(LAYOUT_THREADS)
fwd_rows_layout_kernel(const int8_t* __restrict__ rows,
                       int8_t* __restrict__ d4k, long long n, int rs,
                       long long N4, long long N4p, int C) {
  __shared__ int8_t tile[KB][LAYOUT_COLS + 1];
  const long long G = blockIdx.x;
  const int c0 = blockIdx.y * LAYOUT_COLS;
  const int cols = min(LAYOUT_COLS, C - c0);      // this block's columns
  for (int i = threadIdx.x; i < KB * cols; i += LAYOUT_THREADS) {
    const int r = i / cols, cc = i % cols;
    const int p = r / F_JS, jj = r % F_JS;          // plane, byte column
    const long long j = F_JS * G + jj;
    const long long sample = p * N4 + j;
    const int c = c0 + cc;
    int8_t v = 0;
    if (j < N4 && sample < n && c < rs) v = rows[sample * rs + c];
    // byte column jj = 8t + 2s + h of the group sits at 32s + 16h + 4t + p
    const int t = jj / 8, st = (jj % 8) / 2, h = jj % 2;
    tile[32 * st + 16 * h + 4 * t + p][cc] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KB * cols; i += LAYOUT_THREADS) {
    const int cc = i / KB, pos = i % KB;
    d4k[(long long)(c0 + cc) * 4 * N4p + KB * G + pos] = tile[pos][cc];
  }
}

// ---------------------------------------------------------------------------
// The slices of the product's f64 operands (ops/packed_grm.py _slice_i8):
// both passes' right-hand sides, b [N, R] and the weighted per-variant
// vectors [M, R].  No Pallas kernel did this (the JAX package leaves it to
// XLA's fusion); the plain PyTorch chain takes about fifty elementwise
// passes over [n, R] f64.  Per column r, scale[r] = max_i |x[i, r]| (1
// where that is not above 0), and element (i, r) splits into 8 signed
// 7-bit slices, int8 [n, R, 8]:
//
//   rem = x / scale;  8 times:  d = rint(rem * 64),  rem = (rem - d / 64) * 128
//
// Apart from the one division every step is exact in f64 (|rem| <= 1: a
// scaling by a power of two, or a subtraction whose result is a multiple of
// the ulp of rem and at most 1/128), and rint rounds half to even as
// torch.round does, so the bytes equal the plain chain's.  Two kernels:
// the column max, on |x| as a bit pattern (unsigned order is the order of
// non-negative doubles, with NaN above infinity, as torch.amax propagates
// it), each block's maxima joined by one atomicMax per column (exact and
// independent of order); then the slices, each element's 8 bytes as one
// 8-byte word.  Bound by bytes: x read twice and 8 bytes written per
// element, 24 n R bytes (0.32 ms at n = 430,000, R = 103).  x may have any
// strides: the lanes of a warp run along the axis of the smaller stride
// (the columns of a row-major matrix, the rows of a transposed one), so
// that the reads coalesce, and the warps and blocks along the other.
constexpr int SLICE_LANES = 32;
constexpr int SLICE_WARPS = 8;
constexpr int SLICE_BLOCKS_PER_SM = 8;          // 2,048 threads
constexpr double ROUND_EVEN = 6755399441055744.0;   // 1.5 * 2^52

__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v)) &
         0x7fffffffffffffffull;
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

// The column's scale from its max |x| as bits: the max, or 1 where it is
// not above 0 (zero, or NaN).
__device__ __forceinline__ double column_scale(unsigned long long bits) {
  const double m = __longlong_as_double(static_cast<long long>(bits));
  return m > 0.0 ? m : 1.0;
}

// The 8 slices of v at scale s, slice k in byte k of the word.  With
// |rem * 64| <= 64, adding 1.5 * 2^52 rounds it to an integer d half to
// even, held in the low bits of the sum: its low byte is d as int8.
__device__ __forceinline__ unsigned long long slice_word(double v, double s) {
  double rem = __ddiv_rn(v, s);
  unsigned long long word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const double t = __dadd_rn(__dmul_rn(rem, 64.0), ROUND_EVEN);
    const double d = __dsub_rn(t, ROUND_EVEN);
    word |= static_cast<unsigned long long>(__double2loint(t) & 0xff)
            << (8 * k);
    rem = __dmul_rn(__dsub_rn(rem, __dmul_rn(d, 1.0 / 64.0)), 128.0);
  }
  return word;
}

// amax[r] = max(amax[r], bits of max |x[i, r]|) over the block's rows of
// its 32-column tile (blockIdx.y).  LANE_ROWS: lanes run along the rows.
template <bool LANE_ROWS>
__global__ void __launch_bounds__(SLICE_LANES * SLICE_WARPS)
slice_colmax_kernel(const double* __restrict__ x, long long n, int R,
                    long long si, long long sr,
                    unsigned long long* __restrict__ amax) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c0 = blockIdx.y * SLICE_LANES;
  if (!LANE_ROWS) {
    __shared__ unsigned long long part[SLICE_WARPS][SLICE_LANES];
    const int c = c0 + lane;
    unsigned long long m = 0;
    if (c < R) {
      const double* col = x + c * sr;
#pragma unroll 4
      for (long long i = (long long)blockIdx.x * SLICE_WARPS + warp; i < n;
           i += (long long)gridDim.x * SLICE_WARPS)
        m = umax(m, abs_bits(col[i * si]));
    }
    part[warp][lane] = m;
    __syncthreads();
    if (warp == 0 && c < R) {
      for (int w = 1; w < SLICE_WARPS; ++w) m = umax(m, part[w][lane]);
      if (m != 0) atomicMax(amax + c, m);
    }
    return;
  }
  const int c_end = min(R, c0 + SLICE_LANES);
  for (int c = c0 + warp; c < c_end; c += SLICE_WARPS) {
    const double* col = x + c * sr;
    unsigned long long m = 0;
#pragma unroll 4
    for (long long i = (long long)blockIdx.x * SLICE_LANES + lane; i < n;
         i += (long long)gridDim.x * SLICE_LANES)
      m = umax(m, abs_bits(col[i * si]));
#pragma unroll
    for (int o = SLICE_LANES / 2; o > 0; o >>= 1)
      m = umax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0 && m != 0) atomicMax(amax + c, m);
  }
}

// out[i, r] (8 bytes: the slices of x[i, r]) over the block's rows of its
// 32-column tile, and scale[r] from the first block of the tile.
template <bool LANE_ROWS>
__global__ void __launch_bounds__(SLICE_LANES * SLICE_WARPS)
slice_i8_kernel(const double* __restrict__ x, long long n, int R,
                long long si, long long sr,
                const unsigned long long* __restrict__ amax,
                double* __restrict__ scale,
                unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c0 = blockIdx.y * SLICE_LANES;
  if (!LANE_ROWS) {
    const int c = c0 + lane;
    if (c >= R) return;
    const double s = column_scale(amax[c]);
    if (blockIdx.x == 0 && warp == 0) scale[c] = s;
    const double* col = x + c * sr;
#pragma unroll 2
    for (long long i = (long long)blockIdx.x * SLICE_WARPS + warp; i < n;
         i += (long long)gridDim.x * SLICE_WARPS)
      out[i * R + c] = slice_word(col[i * si], s);
    return;
  }
  const int c_end = min(R, c0 + SLICE_LANES);
  for (int c = c0 + warp; c < c_end; c += SLICE_WARPS) {
    const double s = column_scale(amax[c]);
    if (blockIdx.x == 0 && lane == 0) scale[c] = s;
    const double* col = x + c * sr;
#pragma unroll 2
    for (long long i = (long long)blockIdx.x * SLICE_LANES + lane; i < n;
         i += (long long)gridDim.x * SLICE_LANES)
      out[i * R + c] = slice_word(col[i * si], s);
  }
}

// ---------------------------------------------------------------------------
// host side (the tensor maps: wgmma_s8.cuh)

// A column tile the kernels instantiate that divides C.
bool valid_tile(long long C, int bn) {
  return (bn == 16 || bn == 32 || bn == 64 || bn == 128 || bn == 256) &&
         C > 0 && C % bn == 0;
}

template <int BN>
cudaError_t launch_fwd(const void* packed, const void* d4k, int* out,
                       long long M, long long N4, long long C, int device,
                       cudaStream_t s) {
  using T = Tile<BN>;
  const long long N4p = (N4 + F_JS - 1) / F_JS * F_JS;
  CUtensorMap tp, ts;
  cudaError_t err = encode(&tp, packed, N4, M, N4, F_JS, T::BM,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  err = encode(&ts, d4k, 4 * N4p, C, 4 * N4p, KB, BN,
               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const int smem = T::smem_bytes(T::F_STAGES, T::F_A_BYTES);
  err = cudaFuncSetAttribute(plane_dot_fwd_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // split the byte-column groups so that the blocks (one per SM) fill the
  // card about once
  dim3 grid((unsigned)((M + T::BM - 1) / T::BM), (unsigned)(C / BN), 1u);
  const long long groups = N4p / F_JS;
  const long long tiles = (long long)grid.x * grid.y;
  long long splits = sms / tiles;
  splits = splits < 1 ? 1 : (splits > groups ? groups : splits);
  const long long per = (groups + splits - 1) / splits;
  grid.z = (unsigned)((groups + per - 1) / per);
  plane_dot_fwd_kernel<BN><<<grid, THREADS, smem, s>>>(
      tp, ts, out, (int)M, (int)C, (int)groups, (int)per);
  return cudaGetLastError();
}

template <bool LANE_ROWS>
cudaError_t launch_slices(const double* x, unsigned long long* amax,
                          double* scale, unsigned long long* out,
                          long long n, int R, long long si, long long sr,
                          int sms, cudaStream_t s) {
  // the blocks of a column tile split the rows so that the grid fills the
  // card about once
  const unsigned tiles = (unsigned)((R + SLICE_LANES - 1) / SLICE_LANES);
  const long long unit = LANE_ROWS ? SLICE_LANES : SLICE_WARPS;
  long long blocks = (long long)SLICE_BLOCKS_PER_SM * sms / tiles;
  const long long most = (n + unit - 1) / unit;
  blocks = blocks > most ? most : blocks;
  const dim3 grid((unsigned)(blocks < 1 ? 1 : blocks), tiles, 1u);
  const dim3 block(SLICE_LANES, SLICE_WARPS, 1u);
  slice_colmax_kernel<LANE_ROWS><<<grid, block, 0, s>>>(x, n, R, si, sr,
                                                        amax);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slice_i8_kernel<LANE_ROWS><<<grid, block, 0, s>>>(x, n, R, si, sr, amax,
                                                    scale, out);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_t(const void* packed, const void* dmt, int* out,
                     long long M, long long N4, long long C,
                     cudaStream_t s) {
  using T = Tile<BN>;
  const long long M16 = (M + 15) / 16 * 16;
  CUtensorMap tp, to;
  cudaError_t err = encode(&tp, packed, N4, M, N4, T_JS, T_VS,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  err = encode(&to, dmt, M16, C, M16, T_VS, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const int smem = T::smem_bytes(T::T_STAGES, T::T_A_BYTES);
  err = cudaFuncSetAttribute(plane_dot_t_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N4 + T::JB - 1) / T::JB), (unsigned)(C / BN),
                  1u);
  plane_dot_t_kernel<BN><<<grid, THREADS, smem, s>>>(
      tp, to, out, N4, (int)C, (int)((M + T_VS - 1) / T_VS));
  return cudaGetLastError();
}

}  // namespace

// B1: zero ``out`` (int32 [M, C]) and launch on ``stream`` with column
// tiles of ``bn``.  ``d4k`` is the slices in the kernel's order, int8
// [C, 4 N4p] (see the header; sg_plane_dot_fwd_layout), 16-byte
// aligned.  ``bn`` is 16, 32, 64, 128 or 256 and divides C; N4 is a
// multiple of 16 with ``packed`` 16-byte aligned; else
// cudaErrorInvalidValue.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int sg_plane_dot_fwd(const void* packed, const void* d4k,
                                void* out, long long M, long long N4,
                                long long C, int bn, int device,
                                void* stream) {
  if (misaligned(packed, N4) || misaligned(d4k, 0) || !valid_tile(C, bn))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)M * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || M == 0 || N4 == 0) return (int)err;
  int* o = static_cast<int*>(out);
  switch (bn) {
    case 16: return (int)launch_fwd<16>(packed, d4k, o, M, N4, C, device, s);
    case 32: return (int)launch_fwd<32>(packed, d4k, o, M, N4, C, device, s);
    case 64: return (int)launch_fwd<64>(packed, d4k, o, M, N4, C, device, s);
    case 128: return (int)launch_fwd<128>(packed, d4k, o, M, N4, C, device, s);
    default: return (int)launch_fwd<256>(packed, d4k, o, M, N4, C, device, s);
  }
}

// B1's operand from the slices' sample rows (fwd_rows_layout_kernel):
// ``rows`` int8 [n, rs] row-major -> ``d4k`` int8 [C, 4 N4p], every byte
// written, on ``stream``.  Needs rs <= C and n <= 4 N4, else
// cudaErrorInvalidValue.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int sg_plane_dot_fwd_layout(const void* rows, void* d4k,
                                       long long n, long long rs,
                                       long long N4, long long C, int device,
                                       void* stream) {
  if (rs > C || n > 4 * N4 || C <= 0 || N4 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long N4p = (N4 + F_JS - 1) / F_JS * F_JS;
  const dim3 grid((unsigned)(N4p / F_JS),
                  (unsigned)((C + LAYOUT_COLS - 1) / LAYOUT_COLS), 1u);
  fwd_rows_layout_kernel<<<grid, LAYOUT_THREADS, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows), static_cast<int8_t*>(d4k), n,
      (int)rs, N4, N4p, (int)C);
  return (int)cudaGetLastError();
}

// B2: write ``out`` (int32 [4, N4, C]) on ``stream`` with column tiles of
// ``bn``; every element is written, so nothing is zeroed.  ``dmt`` is the
// operand in the kernel's layout, int8 [C, M16] (see the header), 16-byte
// aligned.  ``bn``, C, N4 and ``packed`` as for B1, else
// cudaErrorInvalidValue.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int sg_plane_dot_t(const void* packed, const void* dmt, void* out,
                              long long M, long long N4, long long C, int bn,
                              int device, void* stream) {
  if (misaligned(packed, N4) || misaligned(dmt, 0) || !valid_tile(C, bn))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N4 == 0) return 0;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, 4 * (size_t)N4 * (size_t)C *
                                sizeof(int), s);
  int* o = static_cast<int*>(out);
  switch (bn) {
    case 16: return (int)launch_t<16>(packed, dmt, o, M, N4, C, s);
    case 32: return (int)launch_t<32>(packed, dmt, o, M, N4, C, s);
    case 64: return (int)launch_t<64>(packed, dmt, o, M, N4, C, s);
    case 128: return (int)launch_t<128>(packed, dmt, o, M, N4, C, s);
    default: return (int)launch_t<256>(packed, dmt, o, M, N4, C, s);
  }
}

// The slices of f64 ``x`` [n, R] (element (i, r) at x + i si + r sr, in
// elements; 8-byte aligned): zero ``amax`` (uint64 [R], scratch), then the
// column max and the slice kernels on ``stream``, writing ``scale`` (f64
// [R]) and ``out`` (int8 [n, R, 8] row-major, 8-byte aligned).  n = 0
// gives scale 1.  Needs R < 2^21, else cudaErrorInvalidValue.  Returns the
// CUDA error code of the launches (0 = success).
extern "C" int sg_slice_i8(const void* x, void* amax, void* scale, void* out,
                           long long n, long long R, long long si,
                           long long sr, int device, void* stream) {
  if (n < 0 || R < 0 || R >= (1LL << 21) ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || R == 0) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(amax, 0, (size_t)R * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const double* xd = static_cast<const double*>(x);
  unsigned long long* am = static_cast<unsigned long long*>(amax);
  double* sc = static_cast<double*>(scale);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  // lanes along the rows where they lie closer together than the columns
  // (a transposed matrix; one column)
  if (R == 1 || (n > 1 && si < sr))
    return (int)launch_slices<true>(xd, am, sc, o, n, (int)R, si, sr, sms, s);
  return (int)launch_slices<false>(xd, am, sc, o, n, (int)R, si, sr, sms, s);
}
