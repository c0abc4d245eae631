"""Sparse symbolic wavefunction: sum_i c_i |label_i>.

Port of ``quantum_basis_tpu.basis.wavefunction``, the counterpart of the
reference's ``wavefunction<T>`` (src/basis.cc:2205-2577, qbasis.h:516-621) —
a small sparse superposition used for seeding variational bases, inspecting
states, and unit tests. It is plain numpy with sorted-label storage instead
of the reference's circular buffer; only :meth:`Wavefunction.apply` runs on a
device, through the compiled image tables.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.basis.vrnl import decode_vf
from quantum_basis_tpu_torch.ops.apply import _block_images, _group_device
from quantum_basis_tpu_torch.ops.compile import (
    compile_diagonal_complex,
    compile_operator,
)

_AMP_TOL = 1e-12  # drop |c| below this (reference: opr_precision)


class Wavefunction:
    """Sorted sparse superposition over integer state labels."""

    def __init__(self, labels=None, amps=None):
        if labels is None:
            self.labels = np.empty(0, dtype=np.int64)
            self.amps = np.empty(0, dtype=np.complex128)
        else:
            labels = np.asarray(labels, dtype=np.int64)
            amps = np.asarray(amps, dtype=np.complex128)
            order = np.argsort(labels, kind="stable")
            self.labels = labels[order]
            self.amps = amps[order]
            self.simplify()

    @classmethod
    def from_label(cls, label: int, amp=1.0):
        return cls(np.asarray([label]), np.asarray([amp]))

    def simplify(self):
        """Merge duplicate labels, drop tiny amplitudes (reference:
        wavefunction::simplify, src/basis.cc:2407-2446)."""
        if self.labels.size == 0:
            return self
        uniq, inv = np.unique(self.labels, return_inverse=True)
        amps = np.zeros(uniq.size, dtype=np.complex128)
        np.add.at(amps, inv, self.amps)
        keep = np.abs(amps) > _AMP_TOL
        self.labels = uniq[keep]
        self.amps = amps[keep]
        return self

    @property
    def size(self) -> int:
        return int(self.labels.size)

    def norm(self) -> float:
        return float(np.linalg.norm(self.amps))

    def inner(self, other: "Wavefunction") -> complex:
        """<self|other> (reference: inner_product, src/basis.cc:2510-2531)."""
        i = np.searchsorted(self.labels, other.labels)
        i = np.clip(i, 0, max(self.size - 1, 0))
        ok = (self.size > 0) & (self.labels[i] == other.labels)
        return complex(np.sum(np.conj(self.amps[i][ok]) * other.amps[ok]))

    def __add__(self, other: "Wavefunction") -> "Wavefunction":
        return Wavefunction(
            np.concatenate([self.labels, other.labels]),
            np.concatenate([self.amps, other.amps]))

    def __mul__(self, scalar) -> "Wavefunction":
        out = Wavefunction()
        out.labels = self.labels.copy()
        out.amps = self.amps * scalar
        return out

    __rmul__ = __mul__

    def apply(self, mopr, space, device="cuda") -> "Wavefunction":
        """O |psi> through the compiled image tables on ``device`` (the host
        analog of oprXphi over a wavefunction, src/basis.cc:2784-2840)."""
        compiled = compile_operator(mopr, space)
        labels = self.labels
        out_lab = []
        out_amp = []
        if not compiled.diag_terms.q_zero() and labels.size:
            ev = compile_diagonal_complex(compiled.diag_terms, space)
            out_lab.append(labels)
            out_amp.append(ev(space.decode(labels)) * self.amps)
        if compiled.groups and labels.size:
            lab = torch.as_tensor(labels, device=device)
            V, F = decode_vf(space, lab)
            x = torch.as_tensor(self.amps, device=device)
            B = labels.size
            for g in compiled.groups:
                sign, amp, tgt = _block_images(_group_device(g, device), lab,
                                               V, F)
                coef = x[:, None] * (amp * sign[..., None]).reshape(B, -1)
                nz = coef.abs() > _AMP_TOL
                out_lab.append(tgt.reshape(B, -1)[nz].cpu().numpy())
                out_amp.append(coef[nz].cpu().numpy())
        if not out_lab:
            return Wavefunction()
        return Wavefunction(np.concatenate(out_lab), np.concatenate(out_amp))
