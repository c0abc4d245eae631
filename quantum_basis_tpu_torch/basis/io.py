"""Basis persistence: CRC-validated label-array save/load.

Port of ``quantum_basis_tpu.basis.io`` (the reference's
``basis_disk_write/read``, src/miscellaneous.cc:474-547). A basis is a sorted
int64 label array. The file holds a uint64 byte count, the payload (a magic
word, the label count, the labels, all int64) and the CRC32 of the payload as
uint32: the bytes the JAX package's vector I/O writes, written and read here
with numpy and ``zlib``, so that either package reads the other's files.
"""

from __future__ import annotations

import zlib

import numpy as np

_MAGIC = np.int64(0x7162786C61626C73)  # "qbxlabls"


def basis_save(path: str, labels: np.ndarray) -> None:
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    raw = np.concatenate([np.asarray([_MAGIC, labels.size], dtype=np.int64),
                          labels]).tobytes()
    with open(path, "wb") as f:
        f.write(np.uint64(len(raw)).tobytes())
        f.write(raw)
        f.write(np.uint32(zlib.crc32(raw)).tobytes())


def basis_load(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: truncated basis file")
        n = int(np.frombuffer(head, dtype=np.uint64)[0])
        raw = f.read(n)
        tail = f.read(4)
    if len(raw) != n or len(tail) != 4 or zlib.crc32(raw) != int(
            np.frombuffer(tail, dtype=np.uint32)[0]):
        raise ValueError(f"{path}: CRC mismatch")
    payload = np.frombuffer(raw, dtype=np.int64)
    if payload.size < 2 or payload[0] != _MAGIC:
        raise ValueError(f"{path}: not a basis file")
    if payload.size != int(payload[1]) + 2:
        raise ValueError(f"{path}: length mismatch")
    return payload[2:].copy()
