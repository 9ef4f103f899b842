"""Pure-Python reader for R serialization format (RDS / RData).

The reference package stores its null-model checkpoints and golden test
fixtures as ``.rds`` files (reference: ``R/saige_main.r:630-643`` saves the
fitted ``ClassSAIGE_NullModel``; ``inst/unitTests/*.rds`` hold the regression
fixtures).  This module decodes R's XDR serialization (versions 2 and 3) into
plain Python objects so the TPU framework can (a) load reference fixtures for
golden tests and (b) read/write model files interchangeably with R users.

Decoded mapping:
  * atomic vectors  -> numpy arrays (int32 / float64 / bool / object for str)
  * VECSXP (list)   -> ``RList`` (ordered dict-like with optional names)
  * attributes      -> ``.attributes`` dict on the returned wrapper
  * NULL            -> None

Only the SEXP types that appear in R data files are implemented (symbols,
pairlists, atomic vectors, lists, chars, closures are skipped structurally).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
PROMSXP = 5
LANGSXP = 6
SPECIALSXP = 7
BUILTINSXP = 8
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
DOTSXP = 17
VECSXP = 19
EXPRSXP = 20
BCODESXP = 21
EXTPTRSXP = 22
RAWSXP = 24
S4SXP = 25

# pseudo-types used by the serializer
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
PERSISTSXP = 247
CLASSREFSXP = 246
GENERICREFSXP = 245
BCREPDEF = 244
BCREPREF = 243
EMPTYENV_SXP = 242
BASEENV_SXP = 241
ALTREP_SXP = 238

NA_INTEGER = -2147483648
# R's NA_real_ has this exact bit pattern (low word 1954)
NA_REAL_BITS = 0x7FF00000000007A2


@dataclass
class RSymbol:
    name: str


@dataclass
class RObject:
    """A decoded R object with attributes (wrapper for vectors/lists)."""

    value: Any
    attributes: dict = field(default_factory=dict)

    @property
    def names(self):
        n = self.attributes.get("names")
        return None if n is None else list(strip(n))

    def __getitem__(self, key):
        v = strip(self.value)
        if isinstance(key, str):
            names = self.names
            if names is None:
                raise KeyError(key)
            return v[names.index(key)]
        return v[key]

    def get(self, key, default=None):
        try:
            return self[key]
        except (KeyError, ValueError, TypeError, IndexError):
            return default

    def keys(self):
        return self.names or []

    def asdict(self):
        names = self.names or []
        v = strip(self.value)
        return {n: v[i] for i, n in enumerate(names)}

    def __repr__(self):
        cls = self.attributes.get("class")
        tag = f" class={strip(cls)}" if cls is not None else ""
        return f"RObject({type(self.value).__name__}{tag}, names={self.names})"


def strip(x):
    """Unwrap RObject to its raw value."""
    while isinstance(x, RObject):
        x = x.value
    return x


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: list = []

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated RDS stream")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.read(8))[0]

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector: two 32-bit words
            hi = self.u32()
            lo = self.u32()
            return (hi << 32) | lo
        return n

    # ---- item decoding ----

    def item(self):
        flags = self.u32()
        ptype = flags & 0xFF
        # levels = flags >> 12
        has_attr = bool(flags & (1 << 9))
        has_tag = bool(flags & (1 << 10))

        if ptype == NILVALUE_SXP or ptype == NILSXP:
            return None
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if ptype in (GLOBALENV_SXP, EMPTYENV_SXP, BASEENV_SXP, UNBOUNDVALUE_SXP,
                     MISSINGARG_SXP, BASENAMESPACE_SXP):
            return None
        if ptype == SYMSXP:
            sym = RSymbol(self._charsxp())
            self.refs.append(sym)
            return sym
        if ptype in (LISTSXP, LANGSXP, DOTSXP, PROMSXP):
            return self._pairlist(flags, ptype)
        if ptype == CLOSXP:
            # attr? env, formals, body -- skip structurally
            if has_attr:
                self.item()
            self.item(); self.item(); self.item()
            return None
        if ptype == ENVSXP:
            self.u32()  # locked
            placeholder = RObject(None, {"__env__": True})
            self.refs.append(placeholder)
            self.item(); self.item(); self.item(); self.item()
            return placeholder
        if ptype in (NAMESPACESXP, PACKAGESXP, PERSISTSXP):
            obj = self._stringvec()
            self.refs.append(obj)
            return obj
        if ptype == CHARSXP:
            return self._charsxp_body()
        if ptype == LGLSXP:
            n = self.length()
            raw = np.frombuffer(self.read(4 * n), dtype=">i4").astype(np.int32)
            val = np.where(raw == NA_INTEGER, np.int32(-1), raw)
            arr = val.astype(np.int8)
            return self._finish(arr, has_attr)
        if ptype == INTSXP:
            n = self.length()
            arr = np.frombuffer(self.read(4 * n), dtype=">i4").astype(np.int32)
            return self._finish(arr, has_attr)
        if ptype == REALSXP:
            n = self.length()
            arr = np.frombuffer(self.read(8 * n), dtype=">f8").astype(np.float64)
            return self._finish(arr, has_attr)
        if ptype == CPLXSXP:
            n = self.length()
            arr = np.frombuffer(self.read(16 * n), dtype=">c16").astype(np.complex128)
            return self._finish(arr, has_attr)
        if ptype == STRSXP:
            n = self.length()
            arr = np.empty(n, dtype=object)
            for i in range(n):
                arr[i] = self.item()
            return self._finish(arr, has_attr)
        if ptype in (VECSXP, EXPRSXP):
            n = self.length()
            vals = [self.item() for _ in range(n)]
            return self._finish(vals, has_attr)
        if ptype == RAWSXP:
            n = self.length()
            arr = np.frombuffer(self.read(n), dtype=np.uint8)
            return self._finish(arr, has_attr)
        if ptype == S4SXP:
            attrs = self._attr_pairlist() if has_attr else {}
            return RObject({"__s4__": True}, attrs)
        if ptype == ALTREP_SXP:
            return self._altrep()
        raise NotImplementedError(f"RDS SEXP type {ptype} not supported")

    def _finish(self, value, has_attr: bool):
        if has_attr:
            attrs = self._attr_pairlist()
            return RObject(value, attrs)
        return value

    def _charsxp(self) -> str:
        flags = self.u32()
        ptype = flags & 0xFF
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            ref = self.refs[idx - 1]
            return ref.name if isinstance(ref, RSymbol) else ref
        assert ptype == CHARSXP, f"expected CHARSXP, got {ptype}"
        return self._charsxp_body()

    def _charsxp_body(self):
        n = self.i32()
        if n == -1:
            return None  # NA_character_
        return self.read(n).decode("utf-8", errors="replace")

    def _stringvec(self):
        self.u32()  # version/flags
        n = self.i32()
        return [self._charsxp() for _ in range(n)]

    def _pairlist(self, flags, ptype):
        """Decode a pairlist as {tag: value} dict (ordered)."""
        out = {}
        while True:
            has_attr = bool(flags & (1 << 9))
            has_tag = bool(flags & (1 << 10))
            attrs = self._attr_pairlist() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            key = tag.name if isinstance(tag, RSymbol) else (tag if tag else f"_{len(out)}")
            out[key] = car
            # cdr
            flags = self.u32()
            nt = flags & 0xFF
            if nt in (NILVALUE_SXP, NILSXP):
                return out
            if nt not in (LISTSXP, LANGSXP, DOTSXP):
                # cdr is a non-pairlist object (rare) - decode and stop
                self.pos -= 4
                out["__cdr__"] = self.item()
                return out

    def _attr_pairlist(self) -> dict:
        flags = self.u32()
        ptype = flags & 0xFF
        if ptype in (NILVALUE_SXP, NILSXP):
            return {}
        assert ptype == LISTSXP, f"attributes must be pairlist, got {ptype}"
        raw = self._pairlist(flags, ptype)
        return raw

    def _altrep(self):
        info = self.item()  # serialized state: class info pairlist
        state = self.item()
        self.item()  # attr
        # Known altrep classes: compact_intseq, compact_realseq, deferred_string,
        # wrap_integer/real/string
        name = None
        if isinstance(info, dict):
            vals = list(info.values())
            if vals and isinstance(vals[0], RSymbol):
                name = vals[0].name
        elif isinstance(info, RSymbol):
            name = info.name
        if name == "compact_intseq":
            s = strip(state)
            n, start, step = int(s[0]), s[1], s[2]
            return (np.arange(n) * int(step) + int(start)).astype(np.int32)
        if name == "compact_realseq":
            s = strip(state)
            n, start, step = int(s[0]), s[1], s[2]
            return np.arange(n) * step + start
        if name in ("wrap_integer", "wrap_real", "wrap_string", "wrap_logical",
                    "wrap_complex", "wrap_raw", "deferred_string"):
            # state is (payload . metadata) as a pairlist; payload first
            st = strip(state)
            if isinstance(st, dict):
                st = strip(next(iter(st.values())))
            elif isinstance(st, list):
                st = strip(st[0])
            return st
        raise NotImplementedError(f"ALTREP class {name!r} not supported")


def _decompress(data: bytes) -> bytes:
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)
    if data[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(data)
    if data[:3] == b"BZh":
        return bz2.decompress(data)
    return data


def read_rds(path: str):
    """Read an .rds file into Python objects."""
    data = _decompress(open(path, "rb").read())
    return parse_rds_bytes(data)


def parse_rds_bytes(data: bytes):
    if data[:2] not in (b"X\n", b"B\n", b"A\n"):
        raise ValueError(f"not an RDS stream (magic {data[:2]!r})")
    if data[:2] != b"X\n":
        raise NotImplementedError("only XDR-format RDS supported")
    r = _Reader(data)
    r.read(2)
    version = r.u32()
    r.u32()  # writer version
    r.u32()  # min reader version
    if version >= 3:
        n = r.u32()
        r.read(n)  # native encoding name
    return r.item()


def read_rdata(path: str) -> dict:
    """Read an .rda / .RData file (RDX2/RDX3 magic) into {name: object}."""
    data = _decompress(open(path, "rb").read())
    if data[:4] in (b"RDX2", b"RDX3"):
        data = data[5:]
    obj = parse_rds_bytes(data)
    if isinstance(obj, dict):
        return {k: v for k, v in obj.items()}
    return {"value": obj}
