"""R-compatible random number generation (Mersenne-Twister + Inversion).

The reference's stochastic pieces consume R's RNG so results are
reproducible under ``set.seed(seed)``: Hutchinson trace probes are
``rbinom(n, 1, 0.5)`` draws (``src/saige_fitnull.cpp:648``, re-seeded to the
same seed at every call via ``set_seed`` at ``:109-114``) and variance-ratio
markers come from ``sample.int(n_var, n_var)`` with the pre-3.6.0 "Rounding"
sample kind (``R/saige_main.r:509-511``, ``inst/unitTests/test_SAIGE.R:15``).
This module reimplements exactly those streams so fitted models match the
reference fixtures bit-for-bit at the RNG level.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class RRandom:
    """MT19937 seeded the way R's ``set.seed`` does (RNG.c ``RNG_Init``)."""

    def __init__(self, seed: int):
        self.set_seed(seed)

    def set_seed(self, seed: int):
        s = np.uint32(seed)
        # initial scrambling: 50 LCG steps
        lcg_a = np.uint32(69069)
        with np.errstate(over="ignore"):
            for _ in range(50):
                s = lcg_a * s + np.uint32(1)
            # fill 625 words; word 0 is the mti slot, overwritten by fixup
            words = np.empty(_N + 1, dtype=np.uint32)
            for j in range(_N + 1):
                s = lcg_a * s + np.uint32(1)
                words[j] = s
        self.mt = words[1:].astype(np.uint32).copy()
        self.mti = _N  # "generate a fresh block on next draw"

    def _gen_block(self):
        """Advance the MT state by one full block.

        mt[k] = mt[(k+M)%N] ^ twist(mt[k], mt[(k+1)%N]); updates for
        k >= N-M read already-updated entries, so the vectorized form runs
        in dependency-ordered segments: [0, N-M), [N-M, 2(N-M)), ... and the
        final element (whose ``y`` uses the *new* mt[0]).
        """
        old = self.mt.astype(np.uint64)
        new = np.empty(_N, dtype=np.uint64)

        def twist(cur, nxt, src):
            y = (cur & _UPPER_MASK) | (nxt & _LOWER_MASK)
            mag = np.where(y & 1, np.uint64(_MATRIX_A), np.uint64(0))
            return src ^ (y >> np.uint64(1)) ^ mag

        # segment boundaries where the +M source crosses from old into new
        start = 0
        while start < _N - 1:
            stop = min(start + (_N - _M), _N - 1)
            ks = np.arange(start, stop)
            src_idx = (ks + _M) % _N
            src_vals = np.empty(len(ks), dtype=np.uint64)
            upd = src_idx < start  # (k+M)%N < start -> already updated
            src_vals[~upd] = old[src_idx[~upd]]
            src_vals[upd] = new[src_idx[upd]]
            new[ks] = twist(old[ks], old[ks + 1], src_vals)
            start = stop
        # k = N-1: y uses NEW mt[0]
        new[_N - 1] = twist(old[_N - 1 : _N], new[0 : 1], new[_M - 1 : _M])[0]
        self.mt = new.astype(np.uint32)
        self.mti = 0

    def _raw(self, n: int) -> np.ndarray:
        """n tempered uint32 draws."""
        out = np.empty(n, dtype=np.uint32)
        got = 0
        while got < n:
            if self.mti >= _N:
                self._gen_block()
            take = min(n - got, _N - self.mti)
            y = self.mt[self.mti : self.mti + take].astype(np.uint64)
            y ^= y >> 11
            y ^= (y << 7) & 0x9D2C5680
            y ^= (y << 15) & 0xEFC60000
            y &= 0xFFFFFFFF
            y ^= y >> 18
            out[got : got + take] = y.astype(np.uint32)
            got += take
            self.mti += take
        return out

    def unif_rand(self, n: int) -> np.ndarray:
        """R's unif_rand: u32 * 2^-32 with the (0,1) fixup."""
        u = self._raw(n).astype(np.float64) * 2.3283064365386963e-10
        # fixup: force into the open interval (0,1)
        tiny = 0.5 * 2.328306437080797e-10
        u = np.where(u <= 0.0, tiny, u)
        u = np.where(1.0 - u <= 0.0, 1.0 - tiny, u)
        return u

    def rbinom_one_half(self, n: int) -> np.ndarray:
        """rbinom(n, size=1, prob=0.5): inversion, one uniform each."""
        return (self.unif_rand(n) >= 0.5).astype(np.int32)

    def rademacher(self, n: int) -> np.ndarray:
        """2*rbinom(n,1,0.5) - 1, the reference's Hutchinson probes."""
        return 2 * self.rbinom_one_half(n) - 1

    def sample_int(self, n: int, k: int | None = None) -> np.ndarray:
        """R's sample.int(n, k) under sample.kind="Rounding".

        Pre-3.6.0 algorithm (src/main/random.c do_sample):
          x = 0..n-1; for i in 0..k-1: j = (int)(n_left * unif); take x[j];
          x[j] = x[--n_left].  Returns 1-based values like R.
        """
        if k is None:
            k = n
        x = np.arange(n, dtype=np.int64)
        u = self.unif_rand(k)
        out = np.empty(k, dtype=np.int64)
        n_left = n
        for i in range(k):
            j = int(n_left * u[i])
            out[i] = x[j]
            n_left -= 1
            x[j] = x[n_left]
        return out + 1
