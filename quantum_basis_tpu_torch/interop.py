"""Carry the JAX package's matrices and vectors into the port.

Both packages' objects meet here as numpy arrays: the JAX package's ELL
(``cols``, ``vre``, ``vim``, ``diag``), BSR blocks and split (re, im)
vectors become the port's device tensors, and a full sector's labels and
eigenvectors become a sector of a port ``Model``. This module imports
neither jax nor quantum_basis_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.sparse import EllMatrix


def vec_from_split(re, im=None, device="cpu") -> torch.Tensor:
    """(re, im|None) numpy -> complex128 (or float64 when im is None)."""
    x = np.array(re, dtype=np.float64)
    if im is not None:
        x = x + 1j * np.array(im, dtype=np.float64)
    return torch.as_tensor(x, device=device)


def vec_to_split(x: torch.Tensor):
    """Tensor -> (re, im|None) float64 numpy arrays."""
    a = x.detach().cpu().numpy()
    if np.iscomplexobj(a):
        return a.real.astype(np.float64), a.imag.astype(np.float64)
    return a.astype(np.float64), None


def ell_from_numpy(cols, vre, vim, diag, device="cpu") -> EllMatrix:
    """The JAX package's EllMatrix arrays -> the port's EllMatrix."""
    return EllMatrix(
        torch.as_tensor(np.array(cols, dtype=np.int64), device=device),
        vec_from_split(vre, vim, device),
        torch.as_tensor(np.array(diag, dtype=np.float64), device=device))


def bsr_from_numpy(blocks_re, blocks_im, bi, bj, diag,
                   device="cpu") -> BsrMatrix:
    """The JAX package's BsrMatrix arrays -> the port's BsrMatrix; the matrix
    dimension is ``len(diag)`` (pass the JAX diagonal without its padding)."""
    def t(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                       device=device)

    return BsrMatrix(len(diag), t(blocks_re), t(blocks_im),
                     t(np.array(bi, np.int32)), t(np.array(bj, np.int32)),
                     t(np.array(diag, np.float64)))


def full_sector_from_numpy(model, labels, evals=(), evecs=(), sec: int = 0):
    """Install a full sector of the JAX package in a port ``Model``.

    ``labels``: the JAX sector's sorted labels; ``evecs``: its eigenvectors
    as split (re, im|None) pairs; ``evals``: their energies. The port builds
    its own device residency and matrix-free apply over the same labels, so
    measurements on the carried vectors compare like with like. Returns the
    port's ``Sector``.
    """
    model._set_full_sector(np.array(labels, dtype=np.int64), sec)
    s = model.sec_full[sec]
    s.evals = [float(e) for e in evals]
    s.evecs = [vec_from_split(re, im, device=model.device)
               for re, im in evecs]
    model.eigenvals_full, model.eigenvecs_full = list(s.evals), list(s.evecs)
    return s
