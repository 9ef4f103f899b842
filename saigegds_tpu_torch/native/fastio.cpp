// Native decode kernels for the GDS data plane.
//
// The reference's data plane is C++ throughout (gdsfmt's CoreArray plus the
// SIMD helpers in src/vectorization.cpp); this library is the TPU-framework
// equivalent for the host-side ingestion path: branch-free 2-bit genotype
// unpacking, LEB128 string-offset scanning, and ploidy folding, exposed via
// a plain C ABI for ctypes (no Python.h dependency).
//
// Build: `make -C saigegds_tpu/native` (g++ -O3 -march=native -shared).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__SSSE3__) || defined(__SSE2__)
#include <immintrin.h>
#endif

namespace {

// Byte-wise lookup tables for the diploid (ploidy=2) hot path: one packed
// byte holds two genotypes (two 2-bit allele codes each).  A single table
// gather per byte replaces 4 shift/mask/branch chains — the difference
// between ~80 MB/s and multi-GB/s decode (the reference's dosage decode is
// likewise a lookup, src/saige_fitnull.cpp:480-517).
uint16_t kDosage2[256];      // two int8 dosage codes (3 = missing)
double   kDosage2F64[512];   // same as f64 with NaN for missing
uint32_t kUnpack4[256];      // four unpacked 2-bit codes

// Fold two allele codes into a dosage code {0,1,2}, 3 = missing.  Allele
// pairs involving a second ALT (code 2) sum past 2 — not representable in
// dosage_alt semantics — and fold to missing like a missing allele does;
// split multiallelic sites (vcf2gds --split-multiallelic) for exactness.
inline int8_t fold2(uint8_t a, uint8_t b) {
    return (a == 3u || b == 3u || a + b > 2u) ? (int8_t)3 : (int8_t)(a + b);
}

bool init_luts() {
    for (int v = 0; v < 256; ++v) {
        uint8_t c0 = v & 3u, c1 = (v >> 2) & 3u;
        uint8_t c2 = (v >> 4) & 3u, c3 = (v >> 6) & 3u;
        int8_t d0 = fold2(c0, c1), d1 = fold2(c2, c3);
        kDosage2[v] = (uint16_t)((uint8_t)d0 | ((uint16_t)(uint8_t)d1 << 8));
        // f64 matches the int8 fold exactly: sums past 2 are missing
        kDosage2F64[2 * v]     = (d0 == 3) ? __builtin_nan("")
                                           : (double)d0;
        kDosage2F64[2 * v + 1] = (d1 == 3) ? __builtin_nan("")
                                           : (double)d1;
        kUnpack4[v] = (uint32_t)c0 | ((uint32_t)c1 << 8) |
                      ((uint32_t)c2 << 16) | ((uint32_t)c3 << 24);
    }
    return true;
}
const bool kInited = init_luts();

// Diploid bulk decode: n_bytes packed bytes -> 2*n_bytes int8 dosages.
void dosage2_bulk(const uint8_t* src, size_t n_bytes, int8_t* dst) {
#if defined(__SSSE3__)
    // nibble = one genotype; pshufb maps 16 nibbles -> 16 dosages at once
    alignas(16) int8_t nib_lut[16];
    for (int v = 0; v < 16; ++v) nib_lut[v] = fold2(v & 3u, (v >> 2) & 3u);
    const __m128i lut = _mm_load_si128((const __m128i*)nib_lut);
    const __m128i m0f = _mm_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 16 <= n_bytes; i += 16) {
        __m128i b = _mm_loadu_si128((const __m128i*)(src + i));
        __m128i lo = _mm_and_si128(b, m0f);
        __m128i hi = _mm_and_si128(_mm_srli_epi16(b, 4), m0f);
        __m128i dlo = _mm_shuffle_epi8(lut, lo);   // genotype 0 of each byte
        __m128i dhi = _mm_shuffle_epi8(lut, hi);   // genotype 1 of each byte
        _mm_storeu_si128((__m128i*)(dst + 2 * i),
                         _mm_unpacklo_epi8(dlo, dhi));
        _mm_storeu_si128((__m128i*)(dst + 2 * i + 16),
                         _mm_unpackhi_epi8(dlo, dhi));
    }
    for (; i < n_bytes; ++i)
        std::memcpy(dst + 2 * i, &kDosage2[src[i]], 2);
#else
    for (size_t i = 0; i < n_bytes; ++i)
        std::memcpy(dst + 2 * i, &kDosage2[src[i]], 2);
#endif
}

// Scalar diploid decode of `count` genotypes starting at genotype
// nibble-index `g0` (handles unaligned prefixes/suffixes).
void dosage2_scalar(const uint8_t* src, int64_t g0, int64_t count,
                    int8_t* dst) {
    for (int64_t i = 0; i < count; ++i) {
        int64_t g = g0 + i;
        uint8_t nib = (src[g >> 1] >> ((g & 1) * 4)) & 0x0Fu;
        dst[i] = fold2(nib & 3u, (nib >> 2) & 3u);
    }
}

// Diploid decode of mn genotypes starting `allele_offset` 2-bit codes in
// (allele_offset is always even in practice: rows are whole genotypes).
void dosage2_any(const uint8_t* src, int64_t allele_offset, int64_t mn,
                 int8_t* out) {
    if (mn <= 0) return;
    int64_t g0 = allele_offset >> 1;        // genotype (nibble) index
    int64_t done = 0;
    if (g0 & 1) {                           // align to a byte boundary
        dosage2_scalar(src, g0, 1, out);
        done = 1;
    }
    int64_t bulk_bytes = (mn - done) >> 1;
    if (bulk_bytes > 0)
        dosage2_bulk(src + ((g0 + done) >> 1), (size_t)bulk_bytes,
                     out + done);
    int64_t tail_at = done + 2 * bulk_bytes;
    if (tail_at < mn)
        dosage2_scalar(src, g0 + tail_at, mn - tail_at, out + tail_at);
}

}  // namespace

extern "C" {

// Unpack 2-bit codes, 4 per byte, little-endian within the byte
// (CoreArray dBit2 layout; cf. the reference's lookup decode in
// src/saige_fitnull.cpp:480-517).
void sg_unpack_bit2(const uint8_t* src, size_t nbytes, uint8_t* dst) {
    for (size_t i = 0; i < nbytes; ++i)
        std::memcpy(dst + 4 * i, &kUnpack4[src[i]], 4);
}

// Scan n LEB128-length-prefixed strings (CoreArray dVStr8 payload).
// Writes byte offsets [start, end) per element; returns bytes consumed,
// or -1 if the buffer ends early.
int64_t sg_vstr8_offsets(const uint8_t* data, size_t len, size_t n,
                         int64_t* starts, int64_t* ends) {
    size_t p = 0;
    for (size_t i = 0; i < n; ++i) {
        uint64_t m = 0;
        int shift = 0;
        for (;;) {
            if (p >= len || shift >= 64) return -1;   // corrupt/overlong
            uint8_t byte = data[p++];
            m |= (uint64_t)(byte & 0x7F) << shift;
            if (byte < 0x80) break;
            shift += 7;
        }
        if (p + m > len) return -1;
        starts[i] = (int64_t)p;
        ends[i] = (int64_t)(p + m);
        p += m;
    }
    return (int64_t)p;
}

// Fold a [M, N, ploidy] allele-code array (2-bit codes already unpacked,
// 3 = missing) into [M, N] int8 ALT dosages with 3 = missing.
void sg_geno_fold(const uint8_t* raw, int64_t mn, int64_t ploidy,
                  int8_t* out) {
    for (int64_t i = 0; i < mn; ++i) {
        const uint8_t* g = raw + i * ploidy;
        int sum = 0;
        int miss = 0;
        for (int64_t k = 0; k < ploidy; ++k) {
            miss |= (g[k] == 3);
            sum += g[k];
        }
        out[i] = (miss || sum > 2) ? (int8_t)3 : (int8_t)sum;
    }
}

// Fused: 2-bit packed [M, N, ploidy] stream -> [M, N] int8 dosages.
// nbytes must cover ceil(M*N*ploidy/4) packed bytes.
void sg_bit2_dosage(const uint8_t* src, int64_t mn, int64_t ploidy,
                    int8_t* out) {
    if (ploidy == 2) {
        dosage2_any(src, 0, mn, out);
        return;
    }
    // general ploidy: walk the 2-bit stream
    int64_t idx = 0;     // allele-code index within the stream
    for (int64_t i = 0; i < mn; ++i) {
        int sum = 0, miss = 0;
        for (int64_t k = 0; k < ploidy; ++k, ++idx) {
            uint8_t b = src[idx >> 2];
            uint8_t g = (b >> ((idx & 3) * 2)) & 3u;
            miss |= (g == 3);
            sum += g;
        }
        out[i] = (miss || sum > 2) ? (int8_t)3 : (int8_t)sum;
    }
}

// Same, starting `geno_offset` 2-bit codes into the buffer (for streamed
// variant blocks whose first genotype is not byte-aligned).
void sg_bit2_dosage_off(const uint8_t* src, int64_t geno_offset, int64_t mn,
                        int64_t ploidy, int8_t* out) {
    if (ploidy == 2 && (geno_offset & 1) == 0) {
        dosage2_any(src, geno_offset, mn, out);
        return;
    }
    int64_t idx = geno_offset;
    for (int64_t i = 0; i < mn; ++i) {
        int sum = 0, miss = 0;
        for (int64_t k = 0; k < ploidy; ++k, ++idx) {
            uint8_t b = src[idx >> 2];
            uint8_t g = (b >> ((idx & 3) * 2)) & 3u;
            miss |= (g == 3);
            sum += g;
        }
        out[i] = (miss || sum > 2) ? (int8_t)3 : (int8_t)sum;
    }
}

// f64 ALT-dosage matrix from 2-bit stream: NaN for missing (the
// SeqData.dosage_block hot path).
void sg_bit2_dosage_f64(const uint8_t* src, int64_t mn, int64_t ploidy,
                        double* out) {
    const double kNaN = __builtin_nan("");
    if (ploidy == 2) {
        // whole bytes: two genotypes via the f64 LUT
        int64_t bulk = mn >> 1;
        for (int64_t i = 0; i < bulk; ++i)
            std::memcpy(out + 2 * i, &kDosage2F64[2 * src[i]], 16);
        if (mn & 1) {
            uint8_t nib = src[mn >> 1] & 0x0Fu;
            int8_t d = fold2(nib & 3u, (nib >> 2) & 3u);
            out[mn - 1] = (d == 3) ? kNaN : (double)d;
        }
        return;
    }
    int64_t idx = 0;
    for (int64_t i = 0; i < mn; ++i) {
        int sum = 0, miss = 0;
        for (int64_t k = 0; k < ploidy; ++k, ++idx) {
            uint8_t b = src[idx >> 2];
            uint8_t g = (b >> ((idx & 3) * 2)) & 3u;
            miss |= (g == 3);
            sum += g;
        }
        out[i] = (miss || sum > 2) ? kNaN : (double)sum;
    }
}

// Gap-coded sparse genotype transport encoder (ops/sparse_codes.py): one
// uint16 entry ((gap << 2) | code) per nonzero, escape entries (code 0)
// bridge gaps beyond 16383.  Zero runs skip 16 bytes per SSE2 compare, so
// rare-variant blocks encode at memory speed.  Returns entries written
// (caller sizes `out` as nnz + rows * (cols / 16384 + 2)).
int64_t sg_sparse_encode(const int8_t* codes, int64_t rows, int64_t cols,
                         uint16_t* out, int64_t* row_ptr) {
    const int64_t kMaxGap = (1 << 14) - 1;     // stored gap field
    const int64_t kEscStep = kMaxGap + 1;      // cursor advance of an escape
    int64_t k = 0;
    row_ptr[0] = 0;
    for (int64_t r = 0; r < rows; ++r) {
        const int8_t* row = codes + r * cols;
        int64_t prev = -1;
        int64_t j = 0;
        while (j < cols) {
#if defined(__SSE2__)
            while (j + 16 <= cols) {
                __m128i v = _mm_loadu_si128((const __m128i*)(row + j));
                int zeros = _mm_movemask_epi8(
                    _mm_cmpeq_epi8(v, _mm_setzero_si128()));
                if (zeros != 0xFFFF) break;
                j += 16;
            }
#endif
            if (j >= cols) break;
            int8_t c = row[j];
            if (c != 0) {
                int64_t d1 = j - prev - 1;
                while (d1 >= kEscStep) {
                    out[k++] = (uint16_t)(kMaxGap << 2);
                    d1 -= kEscStep;
                }
                out[k++] = (uint16_t)((d1 << 2) | (c & 3));
                prev = j;
            }
            ++j;
        }
        row_ptr[r + 1] = k;
    }
    return k;
}

// Per-variant GRM-build moments, fused in one threaded pass: allele
// frequency, 1/sd, per-sample diag(GRM) partials and per-variant missing
// counts from an int8 code matrix [M, N] (values 0/1/2, >=3 missing; the
// reference computes the same quantities in its standardized-lookup build,
// src/saige_fitnull.cpp:159-230).  Replaces a numpy formulation that
// materialized f64 [M, N] standardized copies (~8 B/genotype of transient
// traffic; minutes at biobank scale).  `diag` must be zero-initialized;
// thread partials reduce in thread order (f64 sum order differs from
// numpy's pairwise sums at the ~1e-16 level, inside every test tolerance).
void sg_variant_moments(const int8_t* codes, int64_t M, int64_t N,
                        double* af, double* inv, double* diag,
                        int64_t* miss_cnt) {
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if ((int64_t)T > M) T = (int)M;
    std::vector<std::vector<double>> dbuf((size_t)T);
    std::vector<std::thread> threads;
    int64_t chunk = (M + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            std::vector<double>& db = dbuf[(size_t)t];
            db.assign((size_t)N, 0.0);
            int64_t lo = t * chunk, hi = lo + chunk;
            if (hi > M) hi = M;
            for (int64_t m = lo; m < hi; ++m) {
                const int8_t* row = codes + m * N;
                int64_t nv = 0, s = 0;
                for (int64_t n = 0; n < N; ++n) {
                    int c = row[n];
                    if (c < 3) { ++nv; s += c; }
                }
                miss_cnt[m] = N - nv;
                double a = 0.0, iv = 0.0;
                if (nv > 0) {
                    a = (double)s / (2.0 * (double)nv);
                    double v2 = 2.0 * a * (1.0 - a);
                    if (v2 > 0.0) iv = 1.0 / std::sqrt(v2);
                    else a = 0.0;     // degenerate: zeroed like the
                }                     // numpy path (non-finite -> 0)
                af[m] = a;
                inv[m] = iv;
                if (iv == 0.0) continue;    // zero std values: no diag term
                const double w0 = (0.0 - 2.0 * a) * iv * ((0.0 - 2.0 * a) * iv);
                const double w1 = (1.0 - 2.0 * a) * iv * ((1.0 - 2.0 * a) * iv);
                const double w2 = (2.0 - 2.0 * a) * iv * ((2.0 - 2.0 * a) * iv);
                for (int64_t n = 0; n < N; ++n) {
                    int c = row[n];
                    if (c >= 3) continue;
                    // contract: codes are 0/1/2; mirror the numpy formula
                    // exactly for anything else below 3
                    double w = c == 0 ? w0 : c == 1 ? w1 : c == 2 ? w2
                        : ((double)c - 2.0 * a) * iv
                          * (((double)c - 2.0 * a) * iv);
                    db[(size_t)n] += w;
                }
            }
        });
    }
    for (auto& th : threads) th.join();
    for (int t = 0; t < T; ++t) {
        const double* db = dbuf[(size_t)t].data();
        for (int64_t n = 0; n < N; ++n) diag[n] += db[n];
    }
}

// Missing-entry pair fill (row-major order, matching np.nonzero(codes>=3)):
// offs[m] = exclusive prefix sum of sg_variant_moments' miss_cnt.
void sg_missing_pairs(const int8_t* codes, int64_t M, int64_t N,
                      const int64_t* offs, int32_t* mv, int32_t* ms) {
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if ((int64_t)T > M) T = (int)M;
    std::vector<std::thread> threads;
    int64_t chunk = (M + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (hi > M) hi = M;
            for (int64_t m = lo; m < hi; ++m) {
                const int8_t* row = codes + m * N;
                int64_t k = offs[m];
                for (int64_t n = 0; n < N; ++n) {
                    if (row[n] >= 3) {
                        mv[k] = (int32_t)m;
                        ms[k] = (int32_t)n;
                        ++k;
                    }
                }
            }
        });
    }
    for (auto& th : threads) th.join();
}

// Planar 2-bit pack with missing zeroed in one threaded pass: byte column
// j of row m holds samples j, N4+j, 2*N4+j, 3*N4+j in bit pairs 0/2/4/6
// (N4 = ceil(N/4)); the exact native twin of ops/packed_grm.pack_codes_2bit
// applied to np.where(codes < 3, codes, 0).
void sg_pack2_zeroed(const int8_t* codes, int64_t M, int64_t N,
                     uint8_t* out) {
    const int64_t N4 = (N + 3) / 4;
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if ((int64_t)T > M) T = (int)M;
    std::vector<std::thread> threads;
    int64_t chunk = (M + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (hi > M) hi = M;
            for (int64_t m = lo; m < hi; ++m) {
                const int8_t* row = codes + m * N;
                uint8_t* o = out + m * N4;
                auto g = [&](int64_t n) -> uint8_t {
                    if (n >= N) return 0;
                    int8_t c = row[n];
                    return (c >= 0 && c < 3) ? (uint8_t)c : 0;
                };
                for (int64_t j = 0; j < N4; ++j)
                    o[j] = (uint8_t)(g(j) | (g(N4 + j) << 2) |
                                     (g(2 * N4 + j) << 4) |
                                     (g(3 * N4 + j) << 6));
            }
        });
    }
    for (auto& th : threads) th.join();
}

// Planar 2-bit pack PRESERVING missing (code 3) in one threaded pass —
// the scan-transport twin of sg_pack2_zeroed (the score kernels need the
// missing code intact, ops/score_packed.py).  Rows [M, pad_rows) fill
// with 0xFF (all-missing), matching _pad_block(fill=3) + pack; values
// outside 0..3 clamp to 3 (missing) defensively.
void sg_pack2_raw(const int8_t* codes, int64_t M, int64_t N,
                  int64_t pad_rows, uint8_t* out) {
    const int64_t N4 = (N + 3) / 4;
    const int64_t R = pad_rows > M ? pad_rows : M;
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if ((int64_t)T > M) T = M > 0 ? (int)M : 1;
    std::vector<std::thread> threads;
    int64_t chunk = (M + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (hi > M) hi = M;
            for (int64_t m = lo; m < hi; ++m) {
                const int8_t* row = codes + m * N;
                uint8_t* o = out + m * N4;
                auto g = [&](int64_t n) -> uint8_t {
                    if (n >= N) return 0;
                    int8_t c = row[n];
                    return (c >= 0 && c < 3) ? (uint8_t)c : 3u;
                };
                for (int64_t j = 0; j < N4; ++j)
                    o[j] = (uint8_t)(g(j) | (g(N4 + j) << 2) |
                                     (g(2 * N4 + j) << 4) |
                                     (g(3 * N4 + j) << 6));
            }
        });
    }
    for (auto& th : threads) th.join();
    if (R > M) {
        // pad-row byte pattern: every IN-RANGE sample field is 3, fields
        // past N are 0 — bit-exact with pack(_pad_block(fill=3))
        std::vector<uint8_t> pat((size_t)N4);
        for (int64_t j = 0; j < N4; ++j) {
            uint8_t b = 0;
            for (int k = 0; k < 4; ++k)
                if (k * N4 + j < N) b |= (uint8_t)(3u << (2 * k));
            pat[(size_t)j] = b;
        }
        for (int64_t m = M; m < R; ++m)
            std::memcpy(out + m * N4, pat.data(), (size_t)N4);
    }
}

}  // extern "C"
