"""A frozen SeqArray genotype GDS writer: the benchmark writes its scan
input with this copy, so that a change to the program's own writer
(``saigegds_tpu_torch/io/gds_write.py``, from which this was copied) can
never change what the benchmark reads.

Only the 2-bit genotype node (``genotype/data``, dBit2 [M, N, 2]) and the
variant and sample columns are written, each array one block, the
genotype payload in ZIP_ra frames (independent zlib streams with a frame
table in front), as SeqArray stores a biobank's genotypes compressed."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GDS_MAGIC = b"COREARRAYx0A"
ZIP_FRAME_BYTES = 1 << 22       # plaintext bytes per zlib stream
SGRA_MAGIC = b"SGRA"

_P_NCHILD = bytes.fromhex("08c643754ef601")
_P_DIRENT = bytes.fromhex("01c7437517e57d")
_P_NATTR = bytes.fromhex("0807f37d9d937d")
_P_ATTR = bytes.fromhex("0108f37ddd45791f")
_P_NDIM = bytes.fromhex("07c4e3641f")
_P_DIMS = bytes.fromhex("02c34361")
_P_DATABLK = bytes.fromhex("09c4c37c0c")
_P_EID = bytes.fromhex("0902f500")
_P_EFLAG = bytes.fromhex("0944743112")
_P_ENAME = bytes.fromhex("1544c66010")
_P_PIPE = bytes.fromhex("15c4466d")
_P_PIPESZ = bytes.fromhex("02c9466d50e0512504")


def _u48(v: int) -> bytes:
    return int(v).to_bytes(6, "little")


def _pack7(name: str) -> bytes:
    v = 0
    for i, ch in enumerate(name):
        v |= (ord(ch) & 0x7F) << (7 * i)
    return bytes([len(name)]) + v.to_bytes((7 * len(name) + 7) // 8,
                                           "little")


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _column(arr: np.ndarray):
    """(class, payload, length) of a 1-D column: strings as dVStr8, ints
    as dInt32."""
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        payload = bytearray()
        for s in arr:
            b = str(s).encode("utf-8")
            payload += _leb128(len(b)) + b
        return "dVStr8", bytes(payload), len(arr)
    a = np.asarray(arr, "<i4")
    return "dInt32", a.tobytes(), len(a)


def _zip_ra(payload: bytes) -> bytes:
    spans = [payload[s:s + ZIP_FRAME_BYTES]
             for s in range(0, max(len(payload), 1), ZIP_FRAME_BYTES)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        frames = list(ex.map(lambda s: zlib.compress(s, 1), spans))
    head = SGRA_MAGIC + bytes([1, 0, 0, 0])
    head += struct.pack("<IIQ", len(frames), ZIP_FRAME_BYTES, len(payload))
    head += struct.pack(f"<{len(frames)}I", *[len(f) for f in frames])
    return head + b"".join(frames)


def _array_record(cls: str, dims, data_bid: int, pipe: str = "",
                  raw_size: int = 0, cmp_size: int = 0) -> bytes:
    nprops = 3
    props = bytearray()
    if pipe:
        pb = pipe.encode("utf-8")
        props += _P_PIPE + bytes([0x10, len(pb)]) + pb
        props += _P_PIPESZ + bytes([0x10]) + int(raw_size).to_bytes(
            8, "little") + int(cmp_size).to_bytes(8, "little")
        nprops += 2
    props += _P_NDIM + struct.pack("<H", len(dims))
    props += _P_DIMS + bytes([4 * len(dims)])
    for d in dims:
        props += struct.pack("<I", d)
    props += _P_DATABLK + struct.pack("<I", data_bid)
    body = struct.pack("<H", nprops) + struct.pack("<H", 0x0100) \
        + _pack7(cls) + bytes(props)
    return _u48(len(body) + 6) + body


def _folder_record(children, attrs) -> bytes:
    ents = bytearray()
    for name, bid, is_folder in children:
        nb = name.encode("utf-8")
        p = _P_EID + struct.pack("<I", bid)
        p += _P_EFLAG + struct.pack("<I", 0x2 if is_folder else 0)
        p += _P_ENAME + bytes([len(nb)]) + nb
        ents += _u48(len(p) + 8) + struct.pack("<H", 3) + p
    props = bytearray()
    nprops = 2
    if attrs:
        rec = bytearray()
        for k, v in attrs.items():
            kb, vb = k.encode("utf-8"), v.encode("utf-8")
            rec += bytes([len(kb)]) + kb + bytes([0x0E, len(vb)]) + vb
        props += _P_NATTR + struct.pack("<I", len(attrs))
        props += _P_ATTR + _u48(len(rec) + 6) + rec
        nprops += 2
    props += _P_NCHILD + struct.pack("<I", len(children))
    props += _P_DIRENT + _u48(len(ents) + 6) + bytes(ents)
    body = struct.pack("<H", nprops) + bytes(props)
    return _u48(len(body) + 6) + body


def dbit2_rows(codes):
    """The dBit2 bytes of int8 codes [b, N] (N even), a torch tensor on
    any device: uint8 [b, N / 2], a genotype's two alleles as one nibble
    (0 -> (0,0), 1 -> (0,1), 2 -> (1,1), 3 -> (3,3))."""
    import torch
    if codes.shape[1] % 2:
        raise ValueError("dbit2_rows: an even number of samples")
    lut = torch.tensor([0b0000, 0b0100, 0b0101, 0b1111], dtype=torch.uint8,
                       device=codes.device)
    nib = lut[codes.long()]
    return nib[:, 0::2] | (nib[:, 1::2] << 4)


def write_genotype_gds(path: str, geno: np.ndarray, sample_id) -> int:
    """Write the dBit2 bytes ``geno`` uint8 [M, N / 2] of M variants'
    codes (:func:`dbit2_rows`) as a SeqArray genotype GDS with the N
    given sample ids; returns the bytes written."""
    M, N = geno.shape[0], 2 * geno.shape[1]
    if len(sample_id) != N:
        raise ValueError(f"{len(sample_id)} sample ids for {N} samples")
    geno = np.ascontiguousarray(geno, np.uint8).tobytes()
    blocks = {}
    nxt = [2]

    def array(cls, dims, payload, compress=False):
        nb, db = nxt[0], nxt[0] + 1
        nxt[0] += 2
        if compress:
            packed = _zip_ra(payload)
            blocks[nb] = _array_record(cls, dims, db, "ZIP_ra",
                                       len(payload), len(packed))
            payload = packed
        else:
            blocks[nb] = _array_record(cls, dims, db)
        blocks[db] = payload
        return nb

    def col(arr):
        cls, payload, n = _column(np.asarray(arr))
        return array(cls, (n,), payload)

    geno_data = array("dBit2", (M, N, 2), geno, compress=True)
    folder = nxt[0]
    nxt[0] += 1
    blocks[folder] = _folder_record([("data", geno_data, False)], {})
    ids = np.arange(1, M + 1, dtype=np.int32)
    blocks[1] = _folder_record([
        ("sample.id", col(np.asarray(sample_id, np.int32)), False),
        ("variant.id", col(ids), False),
        ("position", col(ids), False),
        ("chromosome", col(np.asarray(["1"] * M, object)), False),
        ("allele", col(np.asarray(["A,G"] * M, object)), False),
        ("genotype", folder, True),
    ], {"FileFormat": "SEQ_ARRAY", "FileVersion": "v1.0"})
    written = 0
    with open(path, "wb") as f:
        f.write(GDS_MAGIC + struct.pack("<H", 0x0100) + b"\x00" * 4)
        for bid, content in sorted(blocks.items()):
            f.write((22 + len(content) | (1 << 47)).to_bytes(6, "little"))
            f.write(_u48(0) + struct.pack("<I", bid) + _u48(len(content)))
            f.write(content)
        written = f.tell()
    return written
