"""Pure-Python writer for R serialization format (RDS, XDR version 2).

The inverse of ``io/rds.py`` for the subset of SEXP types a
``ClassSAIGE_NullModel`` needs (reference ``R/saige_main.r:630-643`` saves
the fitted model as ``.rds``): atomic vectors (logical/integer/real/
character), generic lists with names, matrices (``dim`` attribute,
column-major payload) and arbitrary attribute pairlists.  Output is
gzip-compressed like R's ``saveRDS`` default, and readable both by R and
by our own reader (round-trip tested).

Python -> R mapping:
  * ``RObject(value, attributes)``  -> value with an attribute pairlist
  * numpy float array               -> REALSXP
  * numpy int array                 -> INTSXP
  * numpy bool array                -> LGLSXP
  * numpy object/str array, str     -> STRSXP of CHARSXPs
  * dict                            -> VECSXP with a ``names`` attribute
  * list/tuple                      -> VECSXP
  * 2-D numpy array                 -> vector + ``dim`` (column-major)
  * None                            -> NULL
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .rds import (CHARSXP, INTSXP, LGLSXP, LISTSXP, NA_INTEGER, NILVALUE_SXP,
                  REALSXP, RObject, STRSXP, SYMSXP, VECSXP, strip)

_HAS_ATTR = 1 << 9
_HAS_TAG = 1 << 10


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def u32(self, v):
        self.out += struct.pack(">I", v & 0xFFFFFFFF)

    def i32(self, v):
        self.out += struct.pack(">i", int(v))

    def f64(self, v):
        self.out += struct.pack(">d", float(v))

    # ---- item encoding ----

    def item(self, x):
        attrs = {}
        if isinstance(x, RObject):
            attrs = dict(x.attributes)
            x = strip(x)
        if x is None:
            self.u32(NILVALUE_SXP)
            return
        if isinstance(x, str):
            x = np.asarray([x], dtype=object)
        if isinstance(x, (bool, np.bool_)):
            x = np.asarray([x], dtype=bool)
        if isinstance(x, (int, np.integer)):
            x = np.asarray([x], dtype=np.int32)
        if isinstance(x, (float, np.floating)):
            x = np.asarray([x], dtype=np.float64)
        if isinstance(x, dict):
            attrs.setdefault("names",
                             np.asarray(list(x.keys()), dtype=object))
            self._flags(VECSXP, attrs)
            self.i32(len(x))
            for v in x.values():
                self.item(v)
            self._attrs(attrs)
            return
        if isinstance(x, (list, tuple)):
            self._flags(VECSXP, attrs)
            self.i32(len(x))
            for v in x:
                self.item(v)
            self._attrs(attrs)
            return
        arr = np.asarray(x)
        if arr.ndim > 1:
            attrs = {"dim": np.asarray(arr.shape, np.int32), **attrs}
            arr = arr.ravel(order="F")   # R matrices are column-major
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            self._flags(STRSXP, attrs)
            self.i32(len(arr))
            for s in arr:
                self._charsxp(None if s is None else str(s))
        elif arr.dtype.kind == "b":
            self._flags(LGLSXP, attrs)
            self.i32(len(arr))
            for v in arr.astype(np.int32):
                self.i32(v)
        elif arr.dtype.kind in ("i", "u"):
            self._flags(INTSXP, attrs)
            self.i32(len(arr))
            for v in arr.astype(np.int64):
                self.i32(NA_INTEGER if v == NA_INTEGER else v)
        elif arr.dtype.kind == "f":
            self._flags(REALSXP, attrs)
            self.i32(len(arr))
            self.out += arr.astype(">f8").tobytes()
        else:
            raise NotImplementedError(f"cannot serialize dtype {arr.dtype}")
        self._attrs(attrs)

    def _flags(self, ptype, attrs):
        self.u32(ptype | (_HAS_ATTR if attrs else 0))

    def _attrs(self, attrs):
        if not attrs:
            return
        for k, v in attrs.items():
            self.u32(LISTSXP | _HAS_TAG)
            self.u32(SYMSXP)
            self._charsxp(k)
            self.item(v)
        self.u32(NILVALUE_SXP)

    def _charsxp(self, s):
        if s is None:                    # NA_character_
            self.u32(CHARSXP)
            self.i32(-1)
            return
        b = s.encode("utf-8")
        # UTF-8 encoding bit (1<<3) in the levels field, like R writes
        self.u32(CHARSXP | ((1 << 3) << 12))
        self.i32(len(b))
        self.out += b


def rds_bytes(obj) -> bytes:
    """Serialize a Python object tree to RDS (XDR, format version 2)."""
    w = _Writer()
    w.out += b"X\n"
    w.u32(2)                             # format version
    w.u32((3 << 16) | (5 << 8))          # writer: R 3.5.0
    w.u32((2 << 16) | (3 << 8))          # min reader: R 2.3.0
    w.item(obj)
    return bytes(w.out)


def _compress_stream(data: bytes, compress) -> bytes:
    """``compress``: True/"gzip" (saveRDS default), "xz" (the reference's
    res.compress="LZMA" mapping, R/assoc_single.r:313), or False."""
    if compress == "xz":
        import lzma
        return lzma.compress(data, format=lzma.FORMAT_XZ, preset=6)
    if compress:
        return gzip.compress(data, 6)
    return data


def write_rds(path: str, obj, compress=True):
    """Write an .rds file (gzip-compressed like R's saveRDS default;
    ``compress="xz"`` for saveRDS's xz mode)."""
    data = _compress_stream(rds_bytes(obj), compress)
    with open(path, "wb") as f:
        f.write(data)


def rdata_bytes(objs: dict) -> bytes:
    """Serialize {name: object} as an RData workspace pairlist."""
    w = _Writer()
    w.out += b"X\n"
    w.u32(2)
    w.u32((3 << 16) | (5 << 8))
    w.u32((2 << 16) | (3 << 8))
    for name, obj in objs.items():
        w.u32(LISTSXP | _HAS_TAG)
        w.u32(SYMSXP)
        w._charsxp(name)
        w.item(obj)
    w.u32(NILVALUE_SXP)
    return bytes(w.out)


def write_rdata(path: str, objs: dict, compress=True):
    """Write an .rda / .RData file (the reference's ``save(glmm, file=)``
    checkpoint container, R/saige_main.r:630-643); readable by R's
    ``load()`` and by ``io.rds.read_rdata``.  ``compress`` as in
    :func:`write_rds`."""
    data = _compress_stream(b"RDX2\n" + rdata_bytes(objs), compress)
    with open(path, "wb") as f:
        f.write(data)
