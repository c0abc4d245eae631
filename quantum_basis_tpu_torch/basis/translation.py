"""Translation symmetry: orbits, representatives, momentum-sector norms.

Port of ``quantum_basis_tpu.basis.translation``. For a batch of states all G
translated labels are one float64 matmul ``V @ stride_perms`` (exact below
2**53), plus a fermion-parity quadratic form, so orbit classification is a
batched scan on the device (the reference's orbit-classification path,
src/model.cc:2316-2427).

Definitions (translation group {T(R)}, G elements, momentum k):

- representative r of an orbit = the minimum label in the orbit;
- P_k = (1/G) sum_R e^{+i k.R} T(R) is the projector onto momentum k;
- norm nu_r = <r|P_k|r> = (1/G) sum_{S in Stab(r)} sigma_S e^{i k.S}
  (cf. norm_trans_repr, src/basis.cc:2104-2202);
- the sector basis is the set of representatives with nu_r > 0.

The fermion parity is computed in float64 (exact for these small integer
sums); the JAX package computes it in float32.
"""

from __future__ import annotations

import numpy as np
import torch


class TranslationSet:
    """All translations of a lattice, precompiled for device use.

    Per group element R: the label permutation as a stride vector
    (new_label = V . stride_perm_R) and the fermionic inversion matrix Q_R
    (parity = F^T Q_R F mod 2); cf. StateSpace.permutation_arrays.
    """

    def __init__(self, space, lattice, device="cuda"):
        if space.label_space > 1 << 53:
            raise OverflowError("label space exceeds exact float64 labels")
        self.space = space
        self.lattice = lattice
        self.device = torch.device(device)
        disps, plans = lattice.translation_group()
        self.disps = disps                     # (G, dim) int
        self.G = disps.shape[0]
        S = space.n_slots
        SP = np.zeros((S, self.G), dtype=np.int64)
        Qs = []
        self.fermionic = space.fermionic
        for g in range(self.G):
            sp, Q = space.permutation_arrays(plans[g])
            SP[:, g] = sp
            Qs.append(Q)
        # exact host copies, packed for the momentum-sector kernels
        # (ops/apply_repr.py::translation_tables)
        self.SP = SP                           # (S, G) int64
        self.Q = np.stack(Qs)                  # (G, S, S) uint8
        self.SPf = torch.as_tensor(SP.astype(np.float64), device=self.device)
        # (S, G*S): Qcat[s, g*S + t] = Q_g[s, t]
        self.Qcat = (torch.as_tensor(
            np.stack(Qs).transpose(1, 0, 2).reshape(S, self.G * S)
            .astype(np.float64), device=self.device)
            if self.fermionic else None)

    def transform_all(self, V, F):
        """All G translations of a batch of states.

        V (..., S) int slot values; F (..., S) fermion counts (float64).
        Returns (labels (..., G) int64, sign (..., G) float64).
        """
        labels = torch.round(V.double() @ self.SPf).long()
        if not self.fermionic:
            return labels, torch.ones(labels.shape, dtype=torch.float64,
                                      device=labels.device)
        S = self.space.n_slots
        Ff = F.double().reshape(-1, S)
        par = ((Ff @ self.Qcat).view(-1, self.G, S) * Ff[:, None, :]).sum(-1)
        sign = 1.0 - 2.0 * torch.remainder(par, 2.0)
        return labels, sign.view(labels.shape)

    def fermion_counts(self, V):
        """Per-slot fermion counts (float64) of decoded slot values V."""
        Ftab = torch.as_tensor(self.space.fermion_count_table,
                               dtype=torch.float64, device=V.device)
        slot = torch.arange(self.space.n_slots, device=V.device)
        return Ftab[slot, V]

    def phases(self, momentum):
        """e^{-i k.R} per group element: (cos (G,), sin (G,)) numpy arrays."""
        ang = -2.0 * np.pi * (self.lattice.k_dot_R(momentum, self.disps)
                              if self.disps.size else np.zeros(self.G))
        return np.cos(ang), np.sin(ang)


def classify_orbits(tset: TranslationSet, labels: np.ndarray,
                    chunk: int = 1 << 16) -> np.ndarray:
    """Orbit minimum (int64, host array) for every basis label."""
    labels = np.asarray(labels, dtype=np.int64)
    out = np.empty(labels.size, dtype=np.int64)
    for start in range(0, labels.size, chunk):
        lab = torch.as_tensor(labels[start:start + chunk], device=tset.device)
        V = tset.space.decode(lab)
        tl, _ = tset.transform_all(V, tset.fermion_counts(V))
        out[start:start + lab.numel()] = tl.min(dim=-1).values.cpu().numpy()
    return out


def sector_norms(tset: TranslationSet, reps: np.ndarray, momentum,
                 chunk: int = 1 << 16) -> np.ndarray:
    """nu_r = <r|P_k|r> for each representative (real, >= 0 up to roundoff).

    The direct stabilizer sum over the whole group (cf. norm_trans_repr,
    src/basis.cc:2104-2202).
    """
    reps = np.asarray(reps, dtype=np.int64)
    cos, sin = tset.phases(momentum)
    cos_d = torch.as_tensor(cos, device=tset.device)
    sin_d = torch.as_tensor(sin, device=tset.device)
    out = np.empty(reps.size, dtype=np.float64)
    for start in range(0, reps.size, chunk):
        lab = torch.as_tensor(reps[start:start + chunk], device=tset.device)
        V = tset.space.decode(lab)
        tl, sg = tset.transform_all(V, tset.fermion_counts(V))
        w = (tl == lab[:, None]).double() * sg
        re = (w * cos_d).sum(dim=-1) / tset.G
        im = (w * sin_d).sum(dim=-1) / tset.G
        if im.numel() and float(im.abs().max()) > 1e-9:
            raise AssertionError("momentum-sector norm has imaginary part")
        out[start:start + lab.numel()] = re.cpu().numpy()
    return out


def enumerate_reps(tset: TranslationSet, labels: np.ndarray) -> np.ndarray:
    """Representatives (orbit minima present in ``labels``); sorted.

    ``labels`` must be the full (sorted) quantum-number-sector basis — the
    orbit of any sector state stays in the sector.
    """
    labels = np.asarray(labels, dtype=np.int64)
    return labels[classify_orbits(tset, labels) == labels]
