// The warpgroup-MMA tile that kernels B3 (indicator_dot_2bit.cu) and B4
// (indicator_dot.cu) share: everything but how a thread turns its codes
// into A words, which each kernel gives as a policy (Planar2, Bytes).
//
// Both compute, for B variants and the slices of the 2K+3 model vectors,
// int32 out[b, x, c] = sum over k of indicator_x(code of b at k) * v[k, c]
// for the three indicators x: g0 (the code, missing as 0), missing
// ([code == 3]) and hom-ALT ([code == 2]).  No .satfinite: every product is
// at most 2 * 64 = 128, so the s32 sums are exact for N < 2^24 samples.
//
// A block is one producer warpgroup and two consumer warpgroups (one block
// per SM).  One thread of the producer keeps a ring of up to 8 stages in
// shared memory filled by TMA: a stage is the slices' tile of BN columns x
// 128 bytes of k, K-major, written with the 128-byte swizzle that the wgmma
// descriptor names, completing on a "full" mbarrier; the consumers release
// it on its "empty" mbarrier (one arrival per consumer warp) once their
// MMAs have read it.  setmaxnreg gives the producer's registers to the
// consumers.  The slices are the model's: the wrapper's caller lays them
// out K-major once per model (ops/score_kernel.py operand_2bit, operand),
// in the k order in which the policy builds its A words, so no call re-lays
// them out.
//
// The codes are the call's and stay as the host packs them: rows of any
// length that start at any byte, which no tensor map takes (its rows must
// start 16-byte aligned).  So each consumer thread loads its own codes from
// device memory straight into registers: per stage, SPAN bytes at byte
// SPAN t of each of its two rows (g and g + 8 of its warp's 16), as the
// aligned words that cover them (a funnel shift puts them together), one
// stage ahead, with the same span four stages ahead prefetched to L2.
// (Variant builds timed on an H100: codes through a 2-D tensor map,
// possible only where rows start 16-byte aligned, were faster; per-row
// bulk copies, possible at any alignment, were slower than these loads.)
//
// Three indicators per code word: a consumer warpgroup owns 64 variants x
// BN columns x all three, so it loads and splits each code word once and
// issues, per stage, 4 k-steps x 3 indicators of wgmma m64nBNk32 with A
// from registers.  That is 3 BN/2 s32 accumulators a thread, 144 at BN =
// 96 beside 48 A registers, within the consumers' 232 without a spill, so
// the tile stops at 96 columns and wider C loops over tiles.  Rows past B
// read as zeros and are never written.  The k range is split so that the
// blocks fill the card about once; the splits' partial sums meet in the
// output through int32 atomicAdd (exact and order-independent, so the
// result is deterministic).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace indicator_tile {

namespace wg = wgmma_s8;

constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int BM = 64 * CONSUMERS;              // variants per block
constexpr int KB = 128;        // k per stage: bytes of a stage's slice row
constexpr int EMPTY_ARRIVALS = 4 * CONSUMERS;   // one per consumer warp
constexpr int STAGES = 8;      // the ring: 96 KB at BN = 96
constexpr int PREFETCH = 4;    // stages ahead of the loads, to L2
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536,
              "the block's registers fit the SM");
constexpr uint32_t LOW2 = 0x03030303u;          // one 2-bit value per byte

// A column tile the kernels instantiate (wgmma's n).
constexpr bool valid_tile(long long bn) {
  return bn == 32 || bn == 64 || bn == 96;
}

template <int BN>
struct Tile {
  static_assert(valid_tile(BN), "a column tile of 32, 64 or 96");
  static constexpr int B_BYTES = KB * BN;       // a stage's slice box
  static_assert(B_BYTES % 1024 == 0, "boxes keep the 1,024-byte alignment");
  static constexpr int SMEM = STAGES * B_BYTES + 2 * STAGES * 8 + 1024;
};

// A thread's SPAN bytes at byte SPAN t of a row's stage, of which the
// first n (0 .. SPAN) are the row's: the aligned words that cover them, no
// word loaded that holds none of them (so nothing past the row's end is
// read), and the rest zero.  Word j of the span is ``word(j)``; its bytes
// past n hold whatever the covering words hold, and the kernels' slices are
// zero there.
template <int SPAN>
struct Span {
  static constexpr int WORDS = SPAN / 4 + 1;
  uint32_t w[WORDS];
  uint32_t shift;

  // ``stage``: the row's stage; ``valid``: its bytes that are the row's.
  __device__ __forceinline__ void fetch(const uint8_t* stage, int valid,
                                        int t) {
    const int n = max(0, min(SPAN, valid - SPAN * t));
    const uintptr_t a = reinterpret_cast<uintptr_t>(stage + SPAN * t);
    const int s = static_cast<int>(a & 3);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(a - s);
    shift = 8u * s;
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
      w[k] = n > 0 && 4 * k < s + n ? __ldg(q + k) : 0u;
  }
  __device__ __forceinline__ uint32_t word(int j) const {
    return __funnelshift_r(w[j], w[j + 1], shift);
  }
};

// The thread's A registers of one stage: a[indicator][k-step][register]
// (registers 0/1: rows g/g+8 at the fragment's k 4t .. 4t+3; 2/3 the same
// rows at k 16 + 4t ..).
using AFrag = uint32_t[3][4][4];

template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                   __cvta_generic_to_global(p)));
}

// A block owns BM variants x BN columns x the stage groups [g_begin,
// g_begin + n) of KB k each.  ``codes`` rows are ``row_bytes`` apart and
// hold that many bytes each.  The policy P gives SPAN (a thread's bytes of
// a row a stage) and build(span, a, rh) (the three indicators' A words of
// row rh from its span).
template <int BN, class P>
__global__ void __launch_bounds__(THREADS, 1)
indicator_kernel(const __grid_constant__ CUtensorMap tm_slices,
                 const uint8_t* __restrict__ codes, int* __restrict__ out,
                 int B, long long row_bytes, int C, int n_groups,
                 int groups_per_split) {
  using T = Tile<BN>;
  constexpr int STAGE_BYTES = 4 * P::SPAN;      // bytes of a row a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t at = wg::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((at + 1023u) & ~1023u) - at);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::B_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int g_begin = blockIdx.z * groups_per_split;
  const int n = min(n_groups - g_begin, groups_per_split);   // >= 1
  const int b0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int wgi = threadIdx.x / 128;

  if (wgi == CONSUMERS) {                  // the producer
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      wg::tma_prefetch_map(&tm_slices);
      for (int it = 0, s = 0, ph = 0; it < n; ++it) {
        wg::mbar_wait(&empty[s], ph ^ 1);
        wg::mbar_expect_tx(&full[s], T::B_BYTES);
        wg::tma_load_2d(ring + s * T::B_BYTES, &tm_slices, &full[s],
                        KB * (g_begin + it), c0);
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  int row[2];
  bool live[2];
  const uint8_t* src[2];                   // the rows' starts
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    row[rh] = b0 + 64 * wgi + 16 * warp + 8 * rh + g;
    live[rh] = row[rh] < B;
    src[rh] = codes + (long long)(live[rh] ? row[rh] : 0) * row_bytes;
  }
  Span<P::SPAN> raw[2];
  // the thread's codes of stage group grp: loaded into registers, or its
  // quarter of the rows' stages brought into L2
  auto fetch = [&](int grp) {
    const long long j = (long long)grp * STAGE_BYTES;
    const int valid = (int)max(0LL, min((long long)STAGE_BYTES,
                                        row_bytes - j));
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      raw[rh].fetch(src[rh] + j, live[rh] ? valid : 0, t);
  };
  auto prefetch = [&](int grp) {
    const long long j = (long long)grp * STAGE_BYTES + STAGE_BYTES / 4 * t;
    if (j >= row_bytes) return;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      if (live[rh]) prefetch_l2(src[rh] + j);
  };

  int acc[3][BN / 2];
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[x][k] = 0;

  for (int i = 1; i < PREFETCH && i < n; ++i) prefetch(g_begin + i);
  fetch(g_begin);
  for (int it = 0, s = 0, ph = 0; it < n; ++it) {
    AFrag a;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) P::build(raw[rh], a, rh);
    if (it + 1 < n) fetch(g_begin + it + 1);    // in flight during the MMAs
    if (it + PREFETCH < n) prefetch(g_begin + it + PREFETCH);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_words(a[x][ks]);
      wg::fence_operand(acc[x]);
    }
    wg::mbar_wait(&full[s], ph);
    wg::fence();
    const uint64_t desc = wg::desc_sw128(wg::smem_u32(ring + s * T::B_BYTES));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int x = 0; x < 3; ++x) wg::mma(acc[x], a[x][ks], desc + 2 * ks);
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int x = 0; x < 3; ++x) wg::fence_operand(acc[x]);
    if (lane == 0) wg::mbar_arrive(&empty[s]);
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (!live[rh]) continue;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      int* o = out + ((long long)row[rh] * 3 + x) * C + c0 + 2 * t;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        atomicAdd(o + 8 * q, acc[x][4 * q + 2 * rh]);
        atomicAdd(o + 8 * q + 1, acc[x][4 * q + 2 * rh + 1]);
      }
    }
  }
}

template <int BN, class P>
cudaError_t launch_tile(const void* codes, const void* slices, int* out,
                        long long B, long long row_bytes, long long width,
                        long long C, int device, cudaStream_t s) {
  CUtensorMap tm;
  cudaError_t err = wg::encode(&tm, slices, width, C, width, KB, BN,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const int smem = Tile<BN>::SMEM;
  err = cudaFuncSetAttribute(indicator_kernel<BN, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // split the stage groups so that the blocks (one per SM) fill the card
  // about once
  dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)(C / BN), 1u);
  const long long groups = width / KB;
  const long long tiles = (long long)grid.x * grid.y;
  long long splits = sms / tiles;
  splits = splits < 1 ? 1 : (splits > groups ? groups : splits);
  const long long per = (groups + splits - 1) / splits;
  grid.z = (unsigned)((groups + per - 1) / per);
  indicator_kernel<BN, P><<<grid, THREADS, smem, s>>>(
      tm, static_cast<const uint8_t*>(codes), out, (int)B, row_bytes,
      (int)C, (int)groups, (int)per);
  return cudaGetLastError();
}

// Zero ``out`` (int32 [B, 3, C]) and launch with column tiles of ``bn`` on
// ``stream``.  ``codes`` holds B rows of ``row_bytes`` bytes, starting at
// any byte; ``slices`` is int8 [C, width] in the policy's k order, width =
// P::width(row_bytes), 16-byte aligned.  ``bn`` is 32, 64 or 96 and
// divides C, else cudaErrorInvalidValue.  Returns the CUDA error code (0 =
// success).
template <class P>
int run(const void* codes, const void* slices, void* out, long long B,
        long long row_bytes, long long C, int bn, int device, void* stream) {
  const long long width = P::width(row_bytes);
  if (wg::misaligned(slices, width) || !valid_tile(bn) || C <= 0 ||
      C % bn != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)B * 3 * (size_t)C * sizeof(int), s);
  if (err != cudaSuccess || B == 0 || row_bytes == 0) return (int)err;
  int* o = static_cast<int*>(out);
  switch (bn) {
    case 32:
      return (int)launch_tile<32, P>(codes, slices, o, B, row_bytes, width,
                                     C, device, s);
    case 64:
      return (int)launch_tile<64, P>(codes, slices, o, B, row_bytes, width,
                                     C, device, s);
    default:
      return (int)launch_tile<96, P>(codes, slices, o, B, row_bytes, width,
                                     C, device, s);
  }
}

}  // namespace indicator_tile
