"""Carry the JAX package's matrices and vectors into the port.

Both packages' objects meet here as numpy arrays: the JAX package's ELL
(``cols``, ``vre``, ``vim``, ``diag``), BSR blocks and split (re, im)
vectors become the port's device tensors, and a full sector's labels and
eigenvectors become a sector of a port ``Model`` (a momentum sector's
labels, representatives and repr-basis eigenvectors likewise), and the
parameter arrays of its window-contraction and kron engines and of its
momentum projector become the port's. Checkpoint records need no converter:
both packages write the same ``.npz`` layout under the same keys
(utils/ckpt.py). ``device`` is a required keyword everywhere: these are entry points of the package, and
none of them picks a device on its own. This module imports neither jax nor
quantum_basis_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply_contract import ContractOp, _complex_of
from quantum_basis_tpu_torch.ops.apply_kron import KronOp, _compact_coupling
from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr, ReprBasis
from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.sparse import EllMatrix
from quantum_basis_tpu_torch.ops.translate_fullspace import (
    MomentumProjector,
    RollTranslations,
)


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
    """The JAX package's EllMatrix arrays -> the port's EllMatrix (its
    int32 columns kept)."""
    return EllMatrix(
        torch.as_tensor(np.array(cols, dtype=np.int32), device=device),
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


def kron_from_numpy(Aside, Bside, adiag, bdiag, P, pscale, *,
                    device) -> KronOp:
    """The JAX package's ``KronOp`` as the port's, from its ``params``
    arrays, in the layout they come from: the dense layout's ``Ad``, ``Bt``
    (``Bt`` may be the same array as ``Ad``), or the ELL layout's ``(Ac,
    Av)``, ``(Bc, Bv)`` pairs (``Bside`` may be the same pair as
    ``Aside``); the dense arrays may come as the JAX engine's 1-tuples. The
    working precision is that of ``Ad`` / ``Av``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    def unwrap(side):
        return side[0] if isinstance(side, tuple) and len(side) == 1 else side

    same = Bside is Aside
    Aside = unwrap(Aside)
    ell = isinstance(Aside, tuple)
    conv = (lambda side: tuple(t(a) for a in side)) if ell else t
    A = conv(Aside)
    B = A if same else conv(unwrap(Bside))
    return KronOp.from_arrays(
        A, B, t(adiag), t(bdiag),
        None if P is None else t(_compact_coupling(P)), pscale,
        layout="ell" if ell else "dense")


def repr_sector_from_numpy(model, momentum, labels, reps, evals=(), evecs=(),
                           sec: int = 0, conserve_lst=None, val_lst=None):
    """Install a momentum sector of the JAX package in a port ``Model``, the
    momentum-sector twin of :func:`full_sector_from_numpy`.

    ``labels``: the sorted labels of the quantum-number sector the JAX
    enumeration materialized (``method="direct"``), or None; ``reps``: its
    orbit representatives (all of them, before the norm filter);
    ``evecs``: eigenvectors over the momentum basis as split (re, im) pairs;
    ``conserve_lst`` / ``val_lst``: the port's conserved operators and their
    values, needed for the quantum-number mask when ``labels`` is None. The
    port builds its own norms, device residency and applies over the same
    representatives. Returns the port's ``Sector``. The model's device is
    used: a model is made for one device.
    """
    from quantum_basis_tpu_torch.models.model import Sector

    reps = np.array(reps, dtype=np.int64)
    labels = None if labels is None else np.array(labels, dtype=np.int64)
    rbasis = ReprBasis(model.space, model.tset,
                       reps if labels is None else labels, momentum,
                       reps_all=reps,
                       work_per_row=max(model.compiled_Ham.nnz_per_row, 1))
    s = Sector()
    s.labels, s.dim, s.dbasis = rbasis.labels_np, rbasis.n, rbasis
    s.matvec = MatvecRepr(model.compiled_Ham, rbasis)
    s.momentum = rbasis.momentum
    s.qn = (("interop", sec, id(s)), list(conserve_lst or []),
            list(val_lst or []), labels)
    s.evals = [float(e) for e in evals]
    s.evecs = [vec_from_split(re, im, device=model.device)
               for re, im in evecs]
    model.sec_repr[sec] = s
    model.eigenvals_repr, model.eigenvecs_repr = list(s.evals), list(s.evecs)
    return s


def rolls_from_numpy(N, specs, signs, *, device) -> RollTranslations:
    """The JAX package's ``RollTranslations`` as the port's, from its block
    transposes: ``specs`` {(dim, shift): [(A, P, Q, B), ...]} (its
    ``_specs``), ``signs`` {(dim, shift): +-1 array over all labels} (its
    ``sign_host``) for the fermionic shifts."""
    return RollTranslations.from_specs(N, specs, signs, device)


def projector_from_numpy(N, momentum, dims, phases, signs_np, specs, *,
                         device) -> MomentumProjector:
    """The JAX package's ``MomentumProjector`` as the port's, from its
    arrays: ``dims`` [(dim, L, [(shift, sign index | None), ...])],
    ``phases`` (its ``_phases_np``), ``signs_np`` (its ``_signs_np``, which
    the sign indices point into) and ``specs`` {(dim, shift): its
    ``rolls._specs(dim, shift)``}."""
    signs = {(d, r): signs_np[sidx] for d, _, shifts in dims
             for r, sidx in shifts if sidx is not None}
    rolls = rolls_from_numpy(N, specs, signs, device=device)
    return MomentumProjector.from_arrays(rolls, momentum, dims, phases)


def vrnl_sector_from_numpy(model, labels, momentum, gs_label, gs_momentum,
                           gs_omega, gs_norm, evals=(), evecs=(),
                           sec: int = 0):
    """Install a variational (vrnl) sector of the JAX package in a port
    ``Model``, the vrnl twin of :func:`full_sector_from_numpy`.

    ``labels``: the JAX sector's canonical labels; ``momentum``,
    ``gs_label``, ``gs_momentum``, ``gs_omega``, ``gs_norm``: its fields of
    the same names; ``evecs``: eigenvectors over the vrnl basis as split
    (re, im|None) pairs; ``evals``: their energies. The port builds its own
    skeleton and matvec over the same labels when a solve or measurement
    needs them. Returns the port's ``VrnlSector``.
    """
    from quantum_basis_tpu_torch.basis.vrnl import VrnlSector

    s = VrnlSector()
    s.labels = np.array(labels, dtype=np.int64)
    s.dim = int(s.labels.size)
    s.momentum = np.array(momentum, dtype=np.float64)
    s.gs_label = int(gs_label)
    s.gs_momentum = np.array(gs_momentum, dtype=np.float64)
    s.gs_omega = int(gs_omega)
    s.gs_norm = float(gs_norm)
    s.evals = [float(e) for e in evals]
    s.evecs = [vec_from_split(re, im, device=model.device).to(torch.complex128)
               for re, im in evecs]
    model.sec_vrnl[sec] = s
    model.eigenvals_vrnl, model.eigenvecs_vrnl = list(s.evals), list(s.evecs)
    return s
