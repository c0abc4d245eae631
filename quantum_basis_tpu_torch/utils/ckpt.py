"""Crash-consistent checkpoint store for long Krylov runs.

Port of ``quantum_basis_tpu.utils.ckpt`` (the re-design of the reference's
two-phase-commit checkpoint files, src/ckpt.cc, src/model.cc:2521-2749).
Each record is one ``.npz`` bundle written to a temp file, flushed to disk
and published with an atomic ``os.replace``, with a CRC32 of every array
checked on load. A corrupt or truncated record loads as ``None``: callers
start cold.

The file layout, the key sanitising and the payload names are the JAX
package's, so a record written by either package loads in the other. Vectors
travel as numpy arrays: a solver splits its complex device tensor into
``*_re`` / ``*_im`` on save (:func:`split_vec`) and joins them on load
(:func:`join_vec`).

Records live under ``config.ckpt_dir`` (default ``out_Qckpt/``, matching the
reference's directory name).
"""

from __future__ import annotations

import os
import struct
import zipfile
import zlib

import numpy as np
import torch

from quantum_basis_tpu_torch import config


class CkptStore:
    """Atomic, CRC-validated named checkpoint records."""

    def __init__(self, root: str | None = None):
        self.root = root or config.ckpt_dir

    def _path(self, key: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in key)
        return os.path.join(self.root, safe + ".Qckpt.npz")

    def save(self, key: str, payload: dict) -> None:
        """Write a record atomically. Values: numpy arrays or scalars."""
        os.makedirs(self.root, exist_ok=True)
        arrays = {}
        crcs = {}
        for name, val in payload.items():
            arr = np.asarray(val)
            arrays[name] = arr
            crcs[name] = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        order = sorted(arrays)
        arrays["__crc__"] = np.asarray([crcs[n] for n in order], dtype=np.uint32)
        arrays["__names__"] = np.asarray(order)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, key: str):
        """Load and validate a record; None if absent, corrupt, truncated or
        of another format."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                names = [str(n) for n in z["__names__"]]
                crcs = z["__crc__"]
                out = {}
                for i, name in enumerate(names):
                    arr = z[name]
                    if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                            != int(crcs[i]):
                        return None
                    out[name] = arr
                return out
        except (OSError, ValueError, KeyError, IndexError, EOFError,
                zipfile.BadZipFile, zlib.error, struct.error):
            # what numpy and zipfile raise on a damaged bundle
            return None

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)


def active_store():
    """The global store if checkpointing is enabled, else None."""
    return CkptStore() if config.enable_ckpt else None


def split_vec(x: torch.Tensor, complex_vec: bool | None = None):
    """Device vector (or stack of vectors) -> (re, im) numpy arrays of its
    real precision; ``im`` is the JAX package's ``zeros(1)`` placeholder for
    a real vector."""
    a = x.detach().cpu().numpy()
    if complex_vec is None:
        complex_vec = np.iscomplexobj(a)
    if not complex_vec:
        return np.ascontiguousarray(a.real), np.zeros(1)
    return (np.ascontiguousarray(a.real),
            np.ascontiguousarray(a.imag) if np.iscomplexobj(a)
            else np.zeros_like(a))


def join_vec(re, im, complex_vec: bool, device, dtype=None) -> torch.Tensor:
    """(re, im) numpy arrays of a record -> one device tensor; ``dtype`` is
    the real precision to convert to (None keeps the record's)."""
    x = torch.as_tensor(np.asarray(re), device=device)
    if dtype is not None:
        x = x.to(dtype)
    if not complex_vec:
        return x
    im = np.asarray(im)
    xi = (torch.as_tensor(im, device=device).to(x.dtype)
          if im.shape == np.asarray(re).shape else torch.zeros_like(x))
    return torch.complex(x, xi)
