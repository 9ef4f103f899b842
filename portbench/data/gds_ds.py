"""A frozen SeqArray imputed-dosage GDS writer: the benchmark writes the
input of its dosage scans with this copy, so that a change to the
program's own writer (``saigegds_tpu_torch/io/gds_write.py``
``write_dosage_gds``, whose layout this follows) can never change what
the benchmark reads.

The file's only dosage source is ``annotation/format/DS``: its ``data``
node holds float32 ALT dosages, dFloat32 [M, N] (variant-major, NaN
missing), one block in ZIP_ra frames (independent zlib streams with a
frame table in front), beside the variant and sample columns; there is
no genotype node, so a reader finds the DS node by itself."""

from __future__ import annotations

import struct

import numpy as np

from .gds import GDS_MAGIC, _array_record, _column, _folder_record, _u48, \
    _zip_ra


def write_dosage_gds(path: str, dosages: np.ndarray, sample_id) -> int:
    """Write the float32 ALT dosages ``dosages`` [M, N] as a SeqArray GDS
    with the N given sample ids; returns the bytes written."""
    ds = np.ascontiguousarray(dosages, "<f4")
    M, N = ds.shape
    if len(sample_id) != N:
        raise ValueError(f"{len(sample_id)} sample ids for {N} samples")
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

    def folder(children):
        nb = nxt[0]
        nxt[0] += 1
        blocks[nb] = _folder_record(children, {})
        return nb

    # the frames are compressed from a view of the array: no copy of it
    ds_data = array("dFloat32", (M, N), memoryview(ds).cast("B"),
                    compress=True)
    fmt = folder([("DS", folder([("data", ds_data, False)]), True)])
    ann = folder([("format", fmt, True)])
    ids = np.arange(1, M + 1, dtype=np.int32)
    blocks[1] = _folder_record([
        ("sample.id", col(np.asarray(sample_id, np.int32)), False),
        ("variant.id", col(ids), False),
        ("position", col(ids), False),
        ("chromosome", col(np.asarray(["1"] * M, object)), False),
        ("allele", col(np.asarray(["A,G"] * M, object)), False),
        ("annotation", ann, True),
    ], {"FileFormat": "SEQ_ARRAY", "FileVersion": "v1.0"})
    with open(path, "wb") as f:
        f.write(GDS_MAGIC + struct.pack("<H", 0x0100) + b"\x00" * 4)
        for bid, content in sorted(blocks.items()):
            f.write((22 + len(content) | (1 << 47)).to_bytes(6, "little"))
            f.write(_u48(0) + struct.pack("<I", bid) + _u48(len(content)))
            f.write(content)
        return f.tell()
