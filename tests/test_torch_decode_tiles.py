"""Kernel B5's two stages (``saigegds_tpu_torch/ops/sparse_codes``): the
tile table of the stream scan and the output-tiled replay.

Tolerance: none — everything here is integers.  On the CPU:

- the plain versions of both stages, composed into a full decode at four
  tile sizes, give exactly the encoded codes and ``decode_codes_plain``;
- that decode equals the JAX package's XLA ``decode_codes`` and its
  Pallas kernel ``decode_codes_pallas`` in interpret mode (save the
  output's last byte, which the Pallas kernel's stream padding
  overwrites: ROADMAP Queue C5);
- ``tile_table_plain`` equals a table and words found entry by entry in
  Python;
- a statement-by-statement Python mirror of ``csrc/decode_codes.cu``
  (spans of 4,096 entries, the warp-shuffle block scan, the decoupled
  look-back over every interleaving of published totals, the 32-bit
  cursor and tile test, the table claims, the tile replay) writes every
  table row exactly once, table and words equal to ``tile_table_plain``'s,
  and decodes the codes.

The streams: rows with one entry per sample; a row longer than several
spans; a span that ends inside an escape run; entries on sample-tile
boundaries; N below one tile and N = 1 (mod 16); runs of empty rows
between long rows; padding past ``row_ptr[n_rows]``; a stream of length
zero.  The ``cuda``-marked cases hold the kernels to the plain versions on
the card, on the same streams and at 2,048 rows x 430,000 samples:
``python -m pytest --noconftest -m cuda tests/test_torch_decode_tiles.py``.
"""

import bisect

import numpy as np
import pytest
import torch

from saigegds_tpu_torch.ops import sparse_codes as tsc

ESC = tsc.ESC_STEP
TILE, CHUNK = tsc.TILE, tsc.CHUNK
THREADS, PER = 256, 16                   # csrc/decode_codes.cu
assert THREADS * PER == CHUNK


def _random_codes(rng, shape, frac):
    codes = np.zeros(shape, np.int8)
    nz = rng.random(shape) < frac
    codes[nz] = rng.choice(np.int8([1, 2, 3]), size=int(nz.sum()))
    return codes


def _case(name: str):
    """(codes [B, N], pad): the codes of one stream; ``pad`` appends
    entries past row_ptr[n_rows] and empty rows."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "dense":                  # one entry per sample, N = 1 mod 16
        codes = _random_codes(rng, (4, 20001), 1.0)
        codes[2] = _random_codes(rng, (20001,), 0.01)
    elif name == "long_row":             # a row of five spans and more
        codes = _random_codes(rng, (6, 30000), 0.002)
        codes[2] = _random_codes(rng, (30000,), 0.8)
    elif name == "escape_at_span_end":   # entries 4090..4100 are escapes
        N = 4090 + 11 * ESC + 200
        codes = np.zeros((3, N), np.int8)
        codes[0, :4090] = rng.integers(1, 4, 4090)
        codes[0, 4090 + 11 * ESC + 5] = 2
        codes[1:] = _random_codes(rng, (2, N), 0.001)
    elif name == "tile_boundary":        # codes at g*TILE - 1 and g*TILE
        codes = _random_codes(rng, (5, 50000), 0.001)
        flat = codes.reshape(-1)
        g = np.arange(TILE, flat.size, TILE)
        flat[g] = 1
        flat[g - 1] = 3
        flat[-1] = 2
    elif name == "narrow":               # N below one tile, many rows a tile
        codes = _random_codes(rng, (37, 503), 0.1)
        codes[0] = 0
        codes[2] = 3
    elif name == "n_mod16_1":
        codes = _random_codes(rng, (7, 16001), 0.05)
        codes[-1, -1] = 1                # the output's last byte
    elif name == "empty_between":        # runs of empty rows, trailing too
        codes = np.zeros((12, 40000), np.int8)
        for r in (0, 5, 8):
            codes[r] = _random_codes(rng, (40000,), 0.5)
        codes[6] = _random_codes(rng, (40000,), 0.0005)
    elif name == "padded":
        codes = _random_codes(rng, (9, 3 * ESC + 10), 0.002)
        codes[3] = 0
        codes[3, [0, ESC, ESC + 1, 3 * ESC + 9]] = [1, 2, 3, 1]
        return codes, True
    elif name == "zero_length":
        codes = np.zeros((7, 300), np.int8)
    else:
        raise KeyError(name)
    return codes, False


CASES = ["dense", "long_row", "escape_at_span_end", "tile_boundary",
         "narrow", "n_mod16_1", "empty_between", "padded", "zero_length"]


def _stream(name: str):
    """(entries, row_ptr, codes) as numpy arrays; padding is zero entries
    (as the JAX package's ``pad_entries`` adds) and five empty rows."""
    codes, pad = _case(name)
    entries, row_ptr = tsc.encode_sparse_rows(codes)
    if pad:                              # zeros, as pad_entries adds
        entries = np.concatenate([entries, np.zeros(4096 - len(entries)
                                                    % 4096 + 7, np.uint16)])
        rp = np.full(len(row_ptr) + 5, row_ptr[-1], np.int32)
        rp[: len(row_ptr)] = row_ptr
        row_ptr = rp
        codes = np.concatenate([codes, np.zeros((5, codes.shape[1]),
                                                np.int8)])
    if name == "escape_at_span_end":
        assert (entries[4090:4101] & 3 == 0).all() and entries[4101] & 3
    if name == "long_row":
        assert row_ptr[3] - row_ptr[2] > 5 * CHUNK
    if name == "zero_length":
        assert len(entries) == 0
    return entries, row_ptr, codes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tile", [16, 48, 1024, TILE])
@pytest.mark.parametrize("name", CASES)
def test_plain_stages_compose(name, tile):
    """tile_table_plain then replay_tiles_plain == the codes ==
    decode_codes_plain, at tiles from 16 bytes to the kernel's."""
    entries, row_ptr, codes = _stream(name)
    B, N = codes.shape
    e, rp = _t(entries), _t(row_ptr)
    table, words = tsc.tile_table_plain(e, rp, B, N, tile)
    assert table.dtype == torch.int64 and words.dtype == torch.uint16
    assert tuple(table.shape) == (-(-(B * N) // tile) + 1,)
    assert tuple(words.shape) == (len(entries),)
    got = tsc.replay_tiles_plain(table, words, B, N, tile)
    np.testing.assert_array_equal(got.numpy(), codes)
    np.testing.assert_array_equal(
        got.numpy(), tsc.decode_codes_plain(e, rp, B, N).numpy())


@pytest.mark.parametrize("name", CASES)
def test_stages_match_jax(name):
    """The staged decode against the JAX package's XLA decode and its
    Pallas kernel in interpret mode (the XLA twin cannot index an empty
    stream)."""
    import jax.numpy as jnp
    from saigegds_tpu.ops import sparse_codes as jsc
    from saigegds_tpu.ops.pallas_sparse import decode_codes_pallas

    entries, row_ptr, codes = _stream(name)
    B, N = codes.shape
    e, rp = _t(entries), _t(row_ptr)
    got = tsc.replay_tiles(*tsc.tile_table(e, rp, B, N), B, N).numpy()
    np.testing.assert_array_equal(got, codes)
    if len(entries):
        np.testing.assert_array_equal(got, np.asarray(jsc.decode_codes(
            jnp.asarray(entries), jnp.asarray(row_ptr), B, N)))
    pallas = np.asarray(decode_codes_pallas(
        jnp.asarray(entries), jnp.asarray(row_ptr), B, N,
        interpret=True)).reshape(-1)
    flat = got.reshape(-1)
    if flat.size and flat[-1]:
        # the Pallas kernel pads its stream with code-0 words aimed at the
        # output's last byte, and they overwrite a code there (ROADMAP
        # Queue C5); the XLA decode and the port keep it
        assert pallas[-1] == 0
        flat = flat[:-1]
    np.testing.assert_array_equal(flat, pallas[: flat.size])


def _walk(entries, row_ptr):
    """Entry by entry: [(k, row, pos, code)] of the entries that belong to
    a row, and the stream's bounds."""
    out, row, cur = [], -1, 0
    s0 = max(int(row_ptr[0]), 0)
    end = max(s0, min(int(row_ptr[-1]), len(entries)))
    for k in range(s0, end):
        r = bisect.bisect_right(row_ptr, k, 1) - 1
        if r != row:
            row, cur = r, 0
        cur += (int(entries[k]) >> 2) + 1
        out.append((k, row, cur - 1, int(entries[k]) & 3))
    return out, s0, end


@pytest.mark.parametrize("name", CASES)
def test_stage1_plain_entry_by_entry(name):
    """Row g of the table: the first entry whose key row * N + min(pos,
    N - 1) reaches min(g * TILE, total), else the stream's end; an entry's
    word: its offset in its tile << 2 | its code, 0 when it writes
    nothing."""
    entries, row_ptr, codes = _stream(name)
    B, N = codes.shape
    walk, s0, end = _walk(entries, row_ptr)
    keys = [row * N + min(pos, N - 1) for _, row, pos, _ in walk]
    want_table = [s0 + bisect.bisect_left(keys, min(g * TILE, B * N))
                  for g in range(-(-(B * N) // TILE) + 1)]
    want_words = np.zeros(len(entries), np.uint16)
    for k, row, pos, code in walk:
        if code and pos < N:
            want_words[k] = ((row * N + pos) % TILE) << 2 | code
    table, words = tsc.tile_table_plain(_t(entries), _t(row_ptr), B, N)
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(words.numpy(), want_words)


# ---- a Python mirror of csrc/decode_codes.cu -----------------------------

AGG, PREFIX = 1, 2
SAT = (1 << 32) - 1
LOG_TILE = 14
assert TILE == 1 << LOG_TILE


def _combine(a, b):
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1])


def _seek(row_ptr, k, lo, n_rows):
    hi = n_rows
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if row_ptr[mid] <= k:
            lo = mid
        else:
            hi = mid
    return lo


def _rel(k, k0):
    return min(PER + 1, max(-1, k - k0))


def _row_at(row_ptr, k, lo, n_rows, k0):
    row, nxt = lo, int(row_ptr[lo + 1])
    if nxt <= k:
        row = _seek(row_ptr, k, lo + 1, n_rows)
        nxt = int(row_ptr[row + 1])
    return [row, _rel(int(row_ptr[row]), k0), _rel(nxt, k0)]


def _block_scan(segs):
    """block_scan, shuffle by shuffle: (exclusive per thread, total)."""
    inc = list(segs)
    for d in (1, 2, 4, 8, 16):
        inc = [_combine(inc[t - d], inc[t]) if t % 32 >= d else inc[t]
               for t in range(THREADS)]
    ex = [(0, 0) if t % 32 == 0 else inc[t - 1] for t in range(THREADS)]
    warp_tot = [inc[32 * w + 31] for w in range(THREADS // 32)]
    excl, total = [], (0, 0)
    for w in warp_tot:
        total = _combine(total, w)
    for t in range(THREADS):
        before = (0, 0)
        for w in range(t // 32):
            before = _combine(before, warp_tot[w])
        excl.append(_combine(before, ex[t]))
    return excl, total


def _look_back(visible, span):
    """look_back: 32 lanes a step, back to the nearest prefix."""
    acc, j = 0, span - 1
    while True:
        words = [visible(j - lane) if j - lane >= 0 else (PREFIX, 0)
                 for lane in range(32)]
        pref = [lane for lane in range(32) if words[lane][0] == PREFIX]
        last = pref[0] if pref else 31
        acc += sum(v for _, v in words[: last + 1])
        if pref:
            return acc
        j -= 32


def _emulate(entries, row_ptr, n_rows, N, rng):
    """table_kernel then tiles_kernel, statement by statement; the
    look-back sees each earlier span's total or its prefix, as ``rng``
    picks, as if those blocks were still looking back themselves."""
    L, total = len(entries), n_rows * N
    n_tiles = -(-total // TILE)
    s0 = max(int(row_ptr[0]), 0)
    end = max(s0, min(int(row_ptr[n_rows]), L))
    table = np.full(n_tiles + 1, -1, np.int64)
    writes = np.zeros(n_tiles + 1, np.int64)
    words = np.zeros(L, np.int64)
    published = []                      # per span: (first word, final word)

    def put(g, start):
        table[g] = start
        writes[g] += 1

    def claim(lo, hi, start):
        g = (lo + TILE) >> LOG_TILE
        while (g << LOG_TILE) <= hi:
            put(g, start)
            g += 1

    for r in range(n_rows):             # rows without entries
        a = max(s0, min(int(row_ptr[r]), end))
        if a == max(s0, min(int(row_ptr[r + 1]), end)):
            claim(r * N - 1, r * N + N - 1, a)
    put(n_tiles, end)
    for span in range(max(1, -(-L // CHUNK))):
        kc = s0 + span * CHUNK
        if kc >= end:
            break
        kend = min(kc + CHUNK, end)
        threads = []
        for t in range(THREADS):
            k0 = kc + t * PER
            n = max(0, min(PER, kend - k0))
            r0, seg = [0, 0, 0], (0, 0)
            if n:
                r0 = _row_at(row_ptr, k0, 0, n_rows, k0)
                r = r0
                for i in range(n):
                    if i >= r[2]:
                        r = _row_at(row_ptr, k0 + i, r[0] + 1, n_rows, k0)
                    if i == r[1]:
                        seg = (1, 0)
                    seg = (seg[0], seg[1] + (int(entries[k0 + i]) >> 2) + 1)
            threads.append((k0, n, r0, seg))
        excl, tot = _block_scan([t[3] for t in threads])
        first = ((PREFIX if tot[0] else AGG), tot[1])
        carry = 0
        if threads[0][2][1] != 0:
            carry = _look_back(
                lambda i: published[i][rng.integers(2)], span)
        published.append((first, first if tot[0] else
                          (PREFIX, carry + tot[1])))

        for (k0, n, r0, _), ex in zip(threads, excl):
            if not n:
                continue
            r = r0
            ph = (r[0] * N) & (TILE - 1)
            end_i = _rel(end, k0)
            cur = ex[1] if ex[0] else min(SAT, carry + ex[1])
            q_prev = ((ph + TILE + min(cur, N) - 1) & SAT) >> LOG_TILE
            for i in range(n):
                k = k0 + i
                if i >= r[2]:
                    r = _row_at(row_ptr, k, r[0] + 1, n_rows, k0)
                    ph = (r[0] * N) & (TILE - 1)
                if i == r[1]:
                    cur = 0
                    q_prev = (ph + TILE - 1) >> LOG_TILE
                before = cur
                step = (int(entries[k]) >> 2) + 1
                cur = SAT if cur >= SAT - step else cur + step
                pos, code = cur - 1, int(entries[k]) & 3
                q = (ph + TILE + min(pos, N - 1)) >> LOG_TILE
                if code and pos < N:
                    words[k] = (((ph + pos) & (TILE - 1)) << 2) | code
                last = i + 1 == r[2] or i + 1 == end_i
                if q != q_prev or last:
                    base = r[0] * N
                    key = base + min(pos, N - 1)
                    claim(base + min(before - 1, N - 1), key, k)
                    if last:
                        claim(key, base + N - 1, k + 1)
                q_prev = q

    out = np.zeros(total, np.int8)
    for g in range(n_tiles):
        t0 = g * TILE
        tile = np.zeros(TILE, np.int8)
        for k in range(int(table[g]), int(table[g + 1])):
            if words[k] & 3:
                tile[words[k] >> 2] = words[k] & 3
        out[t0: t0 + TILE] = tile[: min(TILE, total - t0)]
    return table, writes, words.astype(np.uint16), out.reshape(n_rows, N)


@pytest.mark.parametrize("name", CASES)
def test_kernel_mirror(name):
    """The kernels' algorithm, mirrored in Python: every table row written
    once, table and words equal to tile_table_plain's, and the replay
    gives the codes."""
    entries, row_ptr, codes = _stream(name)
    B, N = codes.shape
    table, writes, words, out = _emulate(entries, row_ptr, B, N,
                                         np.random.default_rng(7))
    assert (writes == 1).all()
    want_table, want_words = tsc.tile_table_plain(_t(entries), _t(row_ptr),
                                                  B, N)
    np.testing.assert_array_equal(table, want_table.numpy())
    np.testing.assert_array_equal(words, want_words.numpy())
    np.testing.assert_array_equal(out, codes)


def test_look_back_any_interleaving():
    """The look-back's carry is the sequential one whichever of its
    predecessors have published their prefix yet: 100 spans, a row start
    in every seventh."""
    rng = np.random.default_rng(3)
    totals = rng.integers(1, 1 << 20, 100)
    starts = np.arange(100) % 7 == 0
    carry_in, c = [], 0
    for s, t in zip(starts, totals):
        carry_in.append(c)
        c = int(t) if s else c + int(t)
    words = [((PREFIX if s else AGG), int(t),
              (PREFIX, int(t) if s else carry_in[i] + int(t)))
             for i, (s, t) in enumerate(zip(starts, totals))]
    for trial in range(20):
        pick = rng.integers(2, size=100)
        vis = lambda i: words[i][2] if pick[i] else words[i][:2]
        for span in range(1, 100):
            assert _look_back(vis, span) == carry_in[span]


def test_stage_wrappers_on_cpu():
    """tile_table and replay_tiles take their plain versions on a CPU
    tensor, count no launch, and refuse a table of the wrong shape or type
    and an empty output."""
    entries, row_ptr, codes = _stream("narrow")
    B, N = codes.shape
    e, rp = _t(entries), _t(row_ptr)
    before = dict(tsc.LAUNCHES)
    table, words = tsc.tile_table(e, rp, B, N)
    want = tsc.tile_table_plain(e, rp, B, N)
    assert torch.equal(table, want[0]) and torch.equal(words, want[1])
    assert torch.equal(tsc.replay_tiles(table, words, B, N),
                       tsc.replay_tiles_plain(table, words, B, N))
    assert tsc.LAUNCHES == before
    with pytest.raises(ValueError):
        tsc.replay_tiles(table[:-1], words, B, N)
    with pytest.raises(ValueError):
        tsc.replay_tiles(table.to(torch.int32), words, B, N)
    with pytest.raises(ValueError):
        tsc.tile_table(e, _t(np.zeros(1, np.int32)), 0, N)
    with pytest.raises(ValueError):
        tsc.tile_table_plain(e, rp, B, N, 2 * TILE)


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _big():
    """The smoke's largest stream: 2,048 rows x 430,000 samples of an
    exome's spectrum, 1% of the rows ALT-major (an entry per sample)."""
    rng = np.random.default_rng(20261016)
    B, N = 2048, 430_000
    codes = np.zeros((B, N), np.int8)
    maf = np.exp(rng.uniform(np.log(1e-4), np.log(5e-2), B))
    for i, k in enumerate(rng.binomial(2 * N, maf).tolist()):
        codes[i, rng.integers(0, N, k)] = rng.integers(1, 3, k)
    alt = np.flatnonzero(rng.random(B) < 0.01)
    codes[alt] = 2 - codes[alt]
    flat = codes.reshape(-1)
    flat[rng.integers(0, flat.size, flat.size // 200)] = 3
    entries, row_ptr = tsc.encode_sparse_rows(codes)
    return entries, row_ptr, codes


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["big"])
def test_kernels_on_card(name):
    """decode_codes on the card == decode_codes_plain == the codes (one
    launch counted), and each stage == its plain version."""
    dev = _card()
    entries, row_ptr, codes = _big() if name == "big" else _stream(name)
    B, N = codes.shape
    e, rp = _t(entries).to(dev), _t(row_ptr).to(dev)
    before = tsc.LAUNCHES["decode_codes"]
    got = tsc.decode_codes(e, rp, B, N)
    torch.cuda.synchronize()
    assert tsc.LAUNCHES["decode_codes"] == before + 1
    assert torch.equal(got, tsc.decode_codes_plain(e, rp, B, N))
    np.testing.assert_array_equal(got.cpu().numpy(), codes)
    table, words = tsc.tile_table(e, rp, B, N)
    want_table, want_words = tsc.tile_table_plain(e, rp, B, N)
    s0, end = int(row_ptr[0]), min(int(row_ptr[-1]), len(entries))
    assert torch.equal(table, want_table)
    assert torch.equal(words[s0:end].to(torch.int64),
                       want_words[s0:end].to(torch.int64))
    assert torch.equal(tsc.replay_tiles(table, words, B, N),
                       tsc.replay_tiles_plain(table, words, B, N))


@pytest.mark.cuda
def test_kernels_on_card_unaligned_entries():
    """Entries at an odd element offset (a view) decode the same."""
    dev = _card()
    entries, row_ptr, codes = _stream("long_row")
    buf = torch.zeros(len(entries) + 3, dtype=torch.uint16, device=dev)
    buf[3:] = _t(entries).to(dev)
    got = tsc.decode_codes(buf[3:], _t(row_ptr).to(dev), *codes.shape)
    np.testing.assert_array_equal(got.cpu().numpy(), codes)
