"""Carry the JAX package's matrices and vectors into the port.

Both packages' objects meet here as numpy arrays: the JAX package's ELL
(``cols``, ``vre``, ``vim``, ``diag``), BSR blocks and split (re, im)
vectors become the port's device tensors, and a full sector's labels and
eigenvectors become a sector of a port ``Model``, and the parameter arrays of
its window-contraction and kron engines become the port's engines. ``device``
is a required keyword everywhere: these are entry points of the package, and
none of them picks a device on its own. This module imports neither jax nor
quantum_basis_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply_contract import ContractOp, _complex_of
from quantum_basis_tpu_torch.ops.apply_kron import KronOp, _compact_coupling
from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.sparse import EllMatrix


def vec_from_split(re, im=None, *, device) -> torch.Tensor:
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


def ell_from_numpy(cols, vre, vim, diag, *, device) -> EllMatrix:
    """The JAX package's EllMatrix arrays -> the port's EllMatrix."""
    return EllMatrix(
        torch.as_tensor(np.array(cols, dtype=np.int64), device=device),
        vec_from_split(vre, vim, device=device),
        torch.as_tensor(np.array(diag, dtype=np.float64), device=device))


def bsr_from_numpy(blocks_re, blocks_im, bi, bj, diag, *,
                   device) -> BsrMatrix:
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


def contract_from_numpy(N, wins, frame_shape, pairs, diag_full, win_G, signs,
                        pair_G, mask=None, passes=(), strides=None, *,
                        dtype, device) -> ContractOp:
    """The JAX package's ``ContractOp`` as the port's, from its arrays.

    The plan fields are the JAX engine's static metadata: ``N``; ``wins``
    [(frame, hi, D, lo, sidx)] in the order of ``win_G``; ``frame_shape``
    {frame: (Q, P)}; ``pairs`` [(A, d_hi, Mmid, d_lo, L, sidx)] in the order
    of ``pair_G``. ``diag_full``, ``win_G`` [(G_re, G_im|None)], ``signs``
    and ``pair_G`` are its ``params``; ``mask`` its sector mask. ``passes``
    (its roll-fallback tuples) need the label ``strides`` of the space.
    """
    def real(a):
        return torch.as_tensor(np.array(a, dtype=np.float64),
                               device=device).to(dtype)

    def g_tensor(re, im):
        """A (G_re, G_im|None) pair as one real or complex tensor."""
        if im is None:
            return real(re)
        return torch.complex(real(re), real(im)).to(_complex_of(dtype))

    return ContractOp.from_arrays(
        N, dtype, device,
        [(f, hi, D, lo, g_tensor(re, im), sidx)
         for (f, hi, D, lo, sidx), (re, im) in zip(wins, win_G)],
        frame_shape,
        [(A, d_hi, Mmid, d_lo, L, g_tensor(re, im), sidx)
         for (A, d_hi, Mmid, d_lo, L, sidx), (re, im) in zip(pairs, pair_G)],
        [real(s) for s in signs], real(diag_full),
        mask=None if mask is None else real(mask),
        passes=passes, strides=strides)


def kron_from_numpy(Ad, Bt, adiag, bdiag, P, pscale, *, device) -> KronOp:
    """The JAX package's dense-layout ``KronOp`` as the port's, from its
    ``params`` arrays (``Bt`` may be the same array as ``Ad``); the working
    precision is that of ``Ad``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    Ad_t = t(Ad)
    return KronOp.from_arrays(
        Ad_t, Ad_t if Bt is Ad else t(Bt), t(adiag), t(bdiag),
        None if P is None else t(_compact_coupling(P)), pscale)
