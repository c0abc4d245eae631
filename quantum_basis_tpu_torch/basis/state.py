"""Many-body product states as fixed-width integer labels.

Port of ``quantum_basis_tpu.basis.state`` (numpy host code; decode/encode
also take torch tensors). Replaces the reference's ``mbasis_elem`` bit-packed byte
strings (reference: src/basis.cc:139-944, src/qbasis.h:342-511). A product
state over "slots" — one slot per (orbital, site) pair, ordered
orbital-major — is the mixed-radix integer

    label = sum_s  v_s * stride_s ,     stride_s = prod_{s' < s} d_{s'}

with slot 0 the least-significant digit. All state manipulation becomes
vectorized integer arithmetic over whole batches of labels:

- ``decode``/``encode`` replace ``siteRead``/``siteWrite`` bit slicing;
- lexicographic state comparison is plain integer comparison (the reference's
  little-endian byte compare has the same semantics on its layout);
- site permutations (``transform``) become a stride re-indexing, with the
  fermionic permutation sign computed as a quadratic form over per-slot
  fermion counts — replacing the bubble-sort swap counting of
  src/basis.cc:598-609 with a batched matmul;
- the Jordan-Wigner sign convention matches the reference exactly: the string
  for an operator at slot s counts fermions on all slots strictly before s in
  orbital-major (orbital, then site) order (src/basis.cc:2650-2664).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np


class StateSpace:
    """The joint local-state structure of a many-body problem.

    Parameters
    ----------
    orbitals : list of (SiteBasis, num_sites)
        One entry per orbital, in the order they were added
        (cf. ``model::add_orbital``).
    """

    def __init__(self, orbitals):
        if not orbitals:
            raise ValueError("at least one orbital required")
        self.orbitals = [(sb, int(n)) for (sb, n) in orbitals]
        dims, slot_orb, slot_site = [], [], []
        for orb_idx, (sb, n_sites) in enumerate(self.orbitals):
            for site in range(n_sites):
                dims.append(sb.dim_local)
                slot_orb.append(orb_idx)
                slot_site.append(site)
        self.dims = np.asarray(dims, dtype=np.int64)          # (S,)
        self.slot_orbital = np.asarray(slot_orb, dtype=np.int32)
        self.slot_site = np.asarray(slot_site, dtype=np.int32)
        self.n_slots = len(dims)
        strides = np.ones(self.n_slots, dtype=np.int64)
        space = 1
        for s in range(self.n_slots):
            strides[s] = space
            nxt = space * int(self.dims[s])
            if nxt > np.iinfo(np.int64).max:
                raise OverflowError("label space exceeds int64")
            space = nxt
        self.strides = strides                                 # (S,)
        self.label_space = space
        self.dim_max = int(self.dims.max())
        # slot lookup: (orbital, site) -> slot index
        self._slot_of = {}
        s = 0
        for orb_idx, (sb, n_sites) in enumerate(self.orbitals):
            for site in range(n_sites):
                self._slot_of[(orb_idx, site)] = s
                s += 1

    # ---------------------------------------------------------------- basics

    def slot(self, site: int, orbital: int = 0) -> int:
        """Slot index of (site, orbital); orbital-major ordering."""
        key = (orbital, site)
        if key not in self._slot_of:
            raise KeyError(f"no slot for site={site}, orbital={orbital}")
        return self._slot_of[key]

    @cached_property
    def fermion_count_table(self) -> np.ndarray:
        """F[s, v] = fermion count of local state v at slot s; (S, dim_max) int32."""
        F = np.zeros((self.n_slots, self.dim_max), dtype=np.int32)
        for s in range(self.n_slots):
            sb = self.orbitals[self.slot_orbital[s]][0]
            F[s, : sb.dim_local] = sb.fermion_counts()
        return F

    @cached_property
    def fermionic(self) -> bool:
        return any(sb.fermionic for sb, _ in self.orbitals)

    # ------------------------------------------------------------ en/decode

    def decode(self, labels):
        """labels (...,) int64 -> per-slot values (..., S).

        numpy in -> int32 numpy out; a torch tensor in -> int64 tensor on
        the same device (int64 so the values index tables directly)."""
        if isinstance(labels, np.ndarray):
            lab = labels[..., None]
            return ((lab // self.strides) % self.dims).astype(np.int32)
        import torch

        strides = torch.as_tensor(self.strides, device=labels.device)
        dims = torch.as_tensor(self.dims, device=labels.device)
        return (labels.long()[..., None] // strides) % dims

    def encode(self, values):
        """Per-slot values (..., S) -> labels (...,) int64. numpy or torch."""
        if isinstance(values, np.ndarray):
            return np.sum(values.astype(np.int64) * self.strides, axis=-1)
        import torch

        strides = torch.as_tensor(self.strides, device=values.device)
        return (values.long() * strides).sum(dim=-1)

    # ------------------------------------------------------------ statistics

    def statistics(self, labels) -> np.ndarray:
        """Occupation histogram per orbital: out[orb, v] = total count over
        slots of that orbital, summed over all given states.

        Replaces ``mbasis_elem::statistics`` (src/basis.cc) as a batched
        diagnostic.
        """
        labels = np.asarray(labels, dtype=np.int64)
        V = self.decode(labels)
        n_orb = len(self.orbitals)
        out = np.zeros((n_orb, self.dim_max), dtype=np.int64)
        for s in range(self.n_slots):
            orb = self.slot_orbital[s]
            out[orb] += np.bincount(V[..., s].ravel(), minlength=self.dim_max)
        return out

    # ---------------------------------------------------- site permutations

    def permutation_arrays(self, plan: np.ndarray):
        """Precompute the stride map and inversion matrix for a site plan.

        ``plan[site] = new_site`` (where each site's value moves TO), applied
        identically within every orbital — the reference's
        ``lattice::translation_plan`` convention (src/lattice.cc:968-981).

        Returns
        -------
        stride_perm : (S,) int64 — new label = V @ stride_perm
        Q : (S, S) uint8 — fermionic inversion-pair indicator; the sign of the
            permutation applied to a state with fermion counts F is
            (-1) ** (F @ Q @ F). Cross-orbital slot order is preserved by
            site permutations, so inversions only arise within an orbital.
        """
        plan = np.asarray(plan, dtype=np.int64)
        # induced slot permutation pi: slot s -> slot (orb, plan[site])
        pi = np.empty(self.n_slots, dtype=np.int64)
        for s in range(self.n_slots):
            orb = int(self.slot_orbital[s])
            site = int(self.slot_site[s])
            pi[s] = self._slot_of[(orb, int(plan[site]))]
        stride_perm = self.strides[pi]
        upper = np.triu(np.ones((self.n_slots, self.n_slots), dtype=bool), k=1)
        inv = (pi[:, None] > pi[None, :]) & upper  # s < t and pi[s] > pi[t]
        Q = inv.astype(np.uint8)
        return stride_perm, Q

    def transform(self, labels, plan: np.ndarray):
        """Apply a site permutation to labels; returns (new_labels, parity).

        parity is 0/1 (int32); the amplitude sign is (-1)**parity. Works on
        numpy arrays (host); the device path is
        :meth:`quantum_basis_tpu_torch.basis.translation.TranslationSet.transform_all`
        with the precomputed arrays from :meth:`permutation_arrays`.
        """
        stride_perm, Q = self.permutation_arrays(plan)
        labels = np.asarray(labels, dtype=np.int64)
        V = self.decode(labels)
        new_labels = V.astype(np.int64) @ stride_perm
        if self.fermionic:
            F = np.take_along_axis(
                self.fermion_count_table, V.astype(np.int64).T, axis=1
            ).T  # (N, S)
            parity = np.einsum("ns,st,nt->n", F, Q.astype(np.int64), F) % 2
        else:
            parity = np.zeros(labels.shape, dtype=np.int64)
        return new_labels, parity.astype(np.int32)
