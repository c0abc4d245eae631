"""Variational ("vrnl") Trugman bases: translate-to-center canonical states.

Port of ``quantum_basis_tpu.basis.vrnl``, the reference's variational-basis
sector for single-polaron-type excitations (reference: src/model.cc:489-616
build, src/model.cc:838-924 matrix, src/model.cc:1915-2143 measurements;
src/basis.cc:661-704 translate2center_OBC; src/basis.cc:2842-2946 basis
growth). States are canonicalized by rigidly translating the occupied
("non-vacuum") sites so their mean coordinate sits at the lattice center;
the recorded displacement carries the momentum phase e^{2*pi*i k.disp}.

Device design: a whole batch of labels is canonicalized at once on the
model's device. Occupancy and centers are two small float64 matmuls; each
state's displacement class selects one column of the translation stride
table, gathered per state, and the canonical label is an exact int64 row sum
(the JAX package computes all G columns as one float64 matmul and keeps one;
both are exact below 2**53, so the labels are the same). The fermion sign of
the selected translation is the quadratic form F Q_g F, evaluated in float64
(exact for these small integer sums) in row chunks. Basis growth keeps its
sets on the device (``torch.unique``, ``torch.isin``) and expands only the
states added in the previous round. The Hamiltonian matrix is a
momentum-independent COO skeleton (rows, cols, amplitude, displacement) built
in row chunks, in the JAX package's entry order and bit for bit, so its
CRC32 (the key of the per-k Wannier records) is the same in both packages;
re-phasing it for a new momentum is O(nnz) host work with no basis re-walk.

Momentum convention: ``momentum`` is the *fractional* wave vector per
lattice unit cell; every phase in this module is exp(+2*pi*i momentum.disp)
(the reference mixes 2*pi-ful and 2*pi-less phases; the JAX package pins the
2*pi-ful convention everywhere, and so does the port).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply import (
    _block_images,
    _block_lookup,
    _group_device,
)
from quantum_basis_tpu_torch.ops.compile import (
    CompiledOperator,
    compile_diagonal,
)

_QN_TOL = 1e-5     # quantum-number tolerance (reference: src/model.cc:520)
_MAG_TOL = 1e-14   # images with |Re amp| + |Im amp| at or below are dropped
# elements of one (rows, G, S) float64 product in the fermion-sign pass
_PARITY_BUDGET = 1 << 24


def decode_vf(space, labels: torch.Tensor, ftab: torch.Tensor | None = None):
    """Labels (N,) on a device -> slot values V (N, S) int64 and fermion
    counts F (N, S) int64. ``ftab``: the space's fermion-count table on the
    labels' device, if the caller keeps one."""
    V = space.decode(labels)
    if ftab is None:
        ftab = torch.as_tensor(space.fermion_count_table.astype(np.int64),
                               device=labels.device)
    slot = torch.arange(space.n_slots, device=labels.device)
    return V, ftab[slot, V]


class CenterTranslator:
    """Batched translate-to-center canonicalization for one (space, lattice).

    Mirrors ``mbasis_elem::translate2center_OBC`` + ``center_pos``
    (reference: src/basis.cc:565-588, 661-704): the canonical form of a
    state translates the mean fractional coordinate of its non-vacuum sites
    onto the lattice center, ``disp = floor(center0 - center1 + 1e-12)``.
    All-vacuum / uniform states are their own canonical form (disp = 0).
    Every table lives on ``device``.
    """

    def __init__(self, space, lattice, device="cuda"):
        if space.label_space > 1 << 53:
            raise OverflowError("label space exceeds exact float64 labels")
        self.space = space
        self.lattice = lattice
        self.device = torch.device(device)
        L = np.asarray(lattice.L, dtype=np.int64)
        self.dim = int(lattice.dim)

        # displacement classes over ALL dimensions (vrnl states are centered;
        # boundary conditions are enforced by construction, not by folding)
        combos = list(itertools.product(*[range(int(l)) for l in L]))
        self.G = len(combos)
        self.disp_classes = np.asarray(combos, dtype=np.int64)   # (G, dim)
        # strides for disp -> class index (last dim fastest, like itertools)
        gstr = np.ones(self.dim, dtype=np.int64)
        for d in range(self.dim - 2, -1, -1):
            gstr[d] = gstr[d + 1] * int(L[d + 1])

        S = space.n_slots
        SP = np.zeros((S, self.G), dtype=np.int64)
        Qs = []
        self.fermionic = space.fermionic
        for g, disp in enumerate(combos):
            sp, Q = space.permutation_arrays(lattice.translation_plan(list(disp)))
            SP[:, g] = sp
            Qs.append(Q)
        self.SP = SP                                              # host, (S, G)
        dev = self.device
        self._SPT = torch.as_tensor(SP.T.copy(), device=dev)      # (G, S)
        # (S, G*S): Qcat[s, g*S + t] = Q_g[s, t]
        self._Qcat = (torch.as_tensor(
            np.stack(Qs).transpose(1, 0, 2).reshape(S, self.G * S)
            .astype(np.float64), device=dev) if self.fermionic else None)
        self._L = torch.as_tensor(L, device=dev)
        self._gstr = torch.as_tensor(gstr, device=dev)
        self._ftab = torch.as_tensor(
            space.fermion_count_table.astype(np.int64), device=dev)

        # per-site fractional positions (coor + pos_sub) and lattice center
        n_sites = lattice.n_sites
        pos = np.zeros((n_sites, self.dim), dtype=np.float64)
        for site in range(n_sites):
            coor, sub = lattice.site2coor(site)
            pos[site] = np.asarray(coor, dtype=np.float64) + lattice.pos_sub[sub]
        self.center0 = pos.mean(axis=0)                           # (dim,)
        self._center0 = torch.as_tensor(self.center0, device=dev)
        self._site_pos = torch.as_tensor(pos, device=dev)
        # slot -> site aggregation matrix (S, n_sites)
        agg = np.zeros((S, n_sites), dtype=np.float64)
        agg[np.arange(S), space.slot_site.astype(np.int64)] = 1.0
        self._agg = torch.as_tensor(agg, device=dev)

    def _decode(self, labels: torch.Tensor):
        return decode_vf(self.space, labels, self._ftab)

    def canonicalize_vf(self, V, F):
        """Canonicalization of decoded states on the device.

        V (N, S) slot values, F (N, S) fermion counts ->
        (canon labels (N,) int64, disp (N, dim) int64, sign (N,) float64).
        The center is float64 in the JAX package's operations and order:
        ``disp`` sits on exact half-integer ties (a lone particle at site 8
        of a 16-site chain: floor(-0.5 + 1e-12) = -1).
        """
        occ_site = ((V != 0).to(torch.float64) @ self._agg) > 0.5  # (N, sites)
        occ_site = occ_site.to(torch.float64)
        npos = occ_site.sum(dim=-1)                                # (N,)
        safe = npos.clamp(min=1.0)
        center1 = (occ_site @ self._site_pos) / safe[:, None]     # (N, dim)
        disp = torch.floor(self._center0 - center1 + 1e-12).long()
        disp = torch.where(npos[:, None] > 0.5, disp, 0)
        g = (torch.remainder(disp, self._L) * self._gstr).sum(dim=-1)
        canon = (V.long() * self._SPT[g]).sum(dim=-1)
        if self.fermionic:
            sign = self._sign(F, g)
        else:
            sign = torch.ones(canon.shape, dtype=torch.float64,
                              device=canon.device)
        return canon, disp, sign

    def _sign(self, F, g):
        """(-1)^(F Q_g F) per state, Q_g of its own class g, in row chunks."""
        S = self.space.n_slots
        n = F.shape[0]
        rows = max(1, _PARITY_BUDGET // (self.G * S))
        Ff = F.to(torch.float64)
        par = torch.empty(n, dtype=torch.float64, device=F.device)
        for a in range(0, n, rows):
            f = Ff[a:a + rows]
            q = (f @ self._Qcat).view(-1, self.G, S)
            qg = q[torch.arange(f.shape[0], device=F.device), g[a:a + rows]]
            par[a:a + rows] = (qg * f).sum(dim=-1)
        return 1.0 - 2.0 * torch.remainder(par, 2.0)

    def canonicalize_t(self, labels: torch.Tensor, chunk: int = 1 << 16):
        """Labels (N,) on the device -> (canon (N,), disp (N, dim),
        sign (N,)) on the device, in label chunks."""
        outs = [self.canonicalize_vf(*self._decode(labels[a:a + chunk]))
                for a in range(0, labels.numel(), chunk)]
        if not outs:
            return (labels.new_empty(0),
                    labels.new_empty((0, self.dim)),
                    torch.empty(0, dtype=torch.float64, device=labels.device))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def canonicalize(self, labels, chunk: int = 1 << 16):
        """Host wrapper: labels (N,) -> (canon (N,), disp (N, dim), sign (N,))
        as numpy arrays; the work runs on the device."""
        lab = torch.as_tensor(np.asarray(labels, dtype=np.int64),
                              device=self.device)
        return tuple(t.cpu().numpy() for t in self.canonicalize_t(lab, chunk))

    def omega_g(self, label: int) -> int:
        """Orbit-size factor omega_g = G / |{translations fixing the state}|
        (reference: src/model.cc:581-598). Host code, one label."""
        V = self.space.decode(np.asarray([label], dtype=np.int64))
        lab_all = (V.astype(np.int64) @ self.SP)[0]
        cnt_repeat = int(np.sum(lab_all == int(label)))
        assert cnt_repeat > 0 and self.G % cnt_repeat == 0
        return self.G // cnt_repeat


class VrnlSector:
    """Per-sector vrnl state (the reference's per-sector arrays
    basis_vrnl/dim_vrnl/momenta_vrnl/gs_* members, src/qbasis.h:1285-1300).
    Labels and momenta are host arrays; eigenvectors are 1-d complex128
    tensors on the model's device."""

    def __init__(self):
        self.labels: np.ndarray | None = None
        self.dim = 0
        self.momentum: np.ndarray | None = None   # fractional k
        self.gs_label: int | None = None
        self.gs_momentum: np.ndarray | None = None
        self.gs_omega = 1                          # omega_g(GS)
        self.gs_norm = 0.0                         # gs_norm_vrnl[sec]
        self.gs_E0: float | None = None            # gs_E0_vrnl
        self.vmat = None                           # VrnlMatrix skeleton
        self.matvec = None                         # MatvecVrnl at momentum
        self.evals: list = []
        self.evecs: list = []


# ---------------------------------------------------------------------------
# Basis growth (gen_mbasis_by_mopr + rm_mbasis_dulp_trans, batched)
# ---------------------------------------------------------------------------


def _conserve_ok(space, evals, vals, labels: torch.Tensor) -> torch.Tensor:
    """Filter device labels by conserved diagonal quantum numbers."""
    if not evals:
        return labels
    V = space.decode(labels)
    ok = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    for ev, v in zip(evals, vals):
        ok &= (ev(V) - v).abs() < _QN_TOL
    return labels[ok]


def grow_basis_vrnl(generator: CompiledOperator, ct: CenterTranslator,
                    seed_labels, depth: int, conserve_lst=None, val_lst=None,
                    chunk: int = 1 << 14) -> np.ndarray:
    """Grow the variational basis: seeds, then ``depth`` rounds of applying
    the generator operator, canonicalizing, and deduplicating
    (reference: gen_mbasis_by_mopr src/basis.cc:2842-2908 +
    rm_mbasis_dulp_trans src/basis.cc:2910-2946). Returns the sorted
    canonical labels (host array), equal to the JAX package's.

    Each round expands only the states the previous round added: the images
    of older states were canonicalized into the basis then. Images are
    computed in chunks of ``chunk`` states; the sets stay on the device.
    """
    space = ct.space
    dev = ct.device
    evals = [compile_diagonal(m, space) for m in (conserve_lst or [])]
    vals = [float(v) for v in (val_lst or [])]

    seeds = np.asarray(sorted(set(int(x) for x in np.asarray(seed_labels))),
                       dtype=np.int64)
    seeds = _conserve_ok(space, evals, vals, torch.as_tensor(seeds,
                                                              device=dev))
    basis = torch.unique(ct.canonicalize_t(seeds)[0])
    frontier = basis
    groups = [_group_device(g, dev) for g in generator.groups]

    for _ in range(int(depth)):
        if frontier.numel() == 0:
            break
        cand = [basis.new_empty(0)]
        for a in range(0, frontier.numel(), chunk):
            lab = frontier[a:a + chunk]
            V, F = ct._decode(lab)
            for g in groups:
                _, amp, tgt = _block_images(g, lab, V, F)
                mag = (amp.real.abs() + amp.imag.abs() if amp.is_complex()
                       else amp.abs())
                cand.append(torch.unique(tgt[mag > _MAG_TOL]))
        cand = _conserve_ok(space, evals, vals, torch.unique(torch.cat(cand)))
        canon = torch.unique(ct.canonicalize_t(cand)[0])
        frontier = canon[~torch.isin(canon, basis)]
        basis = torch.sort(torch.cat([basis, frontier])).values
    return basis.cpu().numpy()


# ---------------------------------------------------------------------------
# Matrix skeleton + momentum re-phasing
# ---------------------------------------------------------------------------


def _group_split(group, device):
    """A TermGroup's device tables with the amplitude kept as its real and
    imaginary tables, as the JAX package holds them: the skeleton stores
    the two parts, down to the sign of a zero."""
    g = _group_device(group, device)
    T, D, K = group.dlt.shape
    g["amp_re"] = torch.as_tensor(group.amp_re.reshape(T * D, K),
                                  device=device)
    g["amp_im"] = (None if group.amp_im is None else torch.as_tensor(
        group.amp_im.reshape(T * D, K), device=device))
    return g


class VrnlMatrix:
    """H over a vrnl basis as a momentum-independent COO skeleton.

    Entry list (i, j, amp, disp): <j|H|i> contributions before phases — the
    matrix at momentum k is ``M[i, j] = sum conj(amp * e^{2 pi i k.disp})``
    (reference: src/model.cc:890-918). ``at_momentum`` re-phases in O(nnz).

    The six arrays (``rows``, ``cols``, ``amp_re``, ``amp_im``, ``disp``,
    ``diag``) are host numpy arrays, bit-equal to the JAX package's and in
    its order: row chunks of ``chunk``, then term groups, then row-major
    within a chunk. The image and canonicalization passes run on the
    translator's device.
    """

    def __init__(self, compiled: CompiledOperator, ct: CenterTranslator,
                 labels: np.ndarray, chunk: int = 1 << 14):
        space = ct.space
        dev = ct.device
        self.space = space
        self.ct = ct
        self.labels = np.asarray(labels, dtype=np.int64)
        n = self.labels.size
        self.n = n

        # diagonal (real fast path), evaluated on the host
        if compiled.diag_terms.q_zero():
            self.diag = np.zeros(n, dtype=np.float64)
        else:
            ev = compile_diagonal(compiled.diag_terms, space)
            self.diag = np.asarray(ev(space.decode(self.labels)))

        groups = [_group_split(g, dev) for g in compiled.groups]
        sorter = np.argsort(self.labels)
        assert np.all(np.diff(self.labels[sorter]) > 0)
        sorter_t = torch.as_tensor(sorter, device=dev)
        lab_sorted = torch.as_tensor(self.labels[sorter], device=dev)
        parts = []
        for start in range(0, n, chunk):
            lab = torch.as_tensor(self.labels[start:start + chunk], device=dev)
            V, F = ct._decode(lab)
            B = lab.shape[0]
            for g in groups:
                sign, flat, tgt = _block_lookup(g, lab, V, F)
                tgt_f = tgt.reshape(B, -1)
                M = tgt_f.shape[1]
                s = sign[..., None]
                ar = (s * g["amp_re"][flat]).reshape(B, M)
                ai = ((s * g["amp_im"][flat]).reshape(B, M)
                      if g["amp_im"] is not None
                      else torch.zeros((B, M), dtype=torch.float64,
                                       device=dev))
                canon, disp, csign = ct.canonicalize_vf(
                    *ct._decode(tgt_f.reshape(-1)))
                csign = csign.view(B, M)
                ar = ar * csign
                ai = ai * csign
                ii, kk = torch.nonzero(ar.abs() + ai.abs() > _MAG_TOL,
                                       as_tuple=True)
                if ii.numel() == 0:
                    continue
                c = canon.view(B, M)[ii, kk]
                pos = torch.searchsorted(lab_sorted, c).clamp(0, max(n - 1, 0))
                ok = lab_sorted[pos] == c
                parts.append((start + ii[ok], sorter_t[pos[ok]],
                              ar[ii, kk][ok], ai[ii, kk][ok],
                              disp.view(B, M, -1)[ii, kk][ok]))

        if parts:
            rows, cols, amp_re, amp_im, disp = (
                torch.cat(p).cpu().numpy() for p in zip(*parts))
            self.rows = rows.astype(np.int64)
            self.cols = cols.astype(np.int64)
            self.amp_re, self.amp_im, self.disp = amp_re, amp_im, disp
        else:
            self.rows = np.empty(0, dtype=np.int64)
            self.cols = np.empty(0, dtype=np.int64)
            self.amp_re = np.empty(0)
            self.amp_im = np.empty(0)
            self.disp = np.empty((0, ct.dim), dtype=np.int64)

    def at_momentum(self, momentum, upper_triangle: bool = True):
        """Dense H(k): M[i, j] = diag + sum conj(amp * e^{2 pi i k.disp}).

        With ``upper_triangle`` (the reference default, qbasis.h:1412-1414)
        only i <= j entries are kept and the strict lower triangle is the
        conjugate transpose — exactly the effective matrix of the reference's
        upper-triangle LIL build + Hermitian CSR descriptor
        (src/model.cc:910-918, src/sparse.cc:276-301). This matters on PBC
        clusters: translate-to-center is not translation-consistent across
        the wrap, so boundary-crossing entries make the raw matrix slightly
        non-Hermitian; the method Hermitizes by construction.
        """
        momentum = np.asarray(momentum, dtype=np.float64)
        ang = 2.0 * np.pi * (self.disp @ momentum)
        amp = self.amp_re + 1j * self.amp_im
        val = np.conj(amp * np.exp(1j * ang))
        H = np.zeros((self.n, self.n), dtype=np.complex128)
        if upper_triangle:
            keep = self.rows <= self.cols
            np.add.at(H, (self.rows[keep], self.cols[keep]), val[keep])
            H = np.triu(H) + np.triu(H, 1).conj().T
        else:
            np.add.at(H, (self.rows, self.cols), val)
            err = np.max(np.abs(H - H.conj().T)) if self.n else 0.0
            if err > 1e-9:
                raise AssertionError(
                    f"H_vrnl(k={momentum}) not Hermitian: err={err:.3e} "
                    "(cf. csr_mat Hermiticity check, src/sparse.cc:235-256)")
        H[np.arange(self.n), np.arange(self.n)] += self.diag
        return H
