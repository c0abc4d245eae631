"""The row kernels' packing (``ops/apply.py::pack_rows``: the column records
``rec``, the interleaved entries ``ad``, the selectors ``gsel``) against the
flat tables that the plain versions read, on the CPU.

The kernels of ``csrc/apply_rows.cu`` read only the packed fields; the
plain versions read only the flat ones. These tests hold the two against
each other on the zoo models (spin-1/2 chain, kagome, Hubbard 3x2, t-J,
Kondo, the DM chain, spin-1, the three-site chain with its arity-3 terms):

- each column's label bit fields give ``V[:, slots]`` on every row, and
  the packing has none where a local dim is not a power of two;
- the diagonal flag is set exactly on the columns whose every ``dlt`` entry
  is 0, every column of Sz(q) among them;
- the interleaved entries equal the flat ``amp`` / ``dlt`` tables;
- the images computed from the packed fields alone, as the kernels compute
  them (record word, bit fields or V, entry, sign; a diagonal column's
  target the row's own label), equal the plain version's on every row;
- ``mopr_x_vec`` of Sz(q) (complex amplitudes, every column diagonal)
  against the JAX ``mopr_x_vec`` in all three index modes (1e-12);
- a direct index's position table, which holds int32 rows, giving the
  same int64 rows as a reference table of int64 rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import Mopr, Opr
from quantum_basis_tpu_torch.basis.index import BasisIndex, lookup_tables
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.interop import vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops import apply as ap
from quantum_basis_tpu_torch.ops.apply import (
    DeviceBasis,
    _parity,
    _row_images,
    mopr_x_vec,
    pack_rows,
    slot_bit_fields,
)

MODES = ["direct", "lin", "bsearch"]

# name: (model, conserved names, values, label bit fields expected)
MODELS = {
    "chain12": (lambda: tz.heisenberg_chain(12), ["Sz"], [0.0], True),
    "kagome_2x1": (lambda: tz.kagome_heisenberg(2, 1), ["Sz"], [0.0], True),
    "hubbard3x2": (lambda: tz.fermi_hubbard_square(3, 2), ["Nup", "Ndn"],
                   [3.0, 3.0], True),
    "tj_chain8": (lambda: tz.tj_chain(8), ["Sz", "N"], [0.0, 6.0], False),
    "kondo4": (lambda: tz.kondo_chain(4, 1.3), ["N", "Sz"], [4.0, 0.0],
               True),
    "dm_chain10": (lambda: tz.dm_chain(10, 0.3), ["Sz"], [0.0], True),
    "spin1_chain8": (lambda: tz.heisenberg_chain(8, spin="1"), ["Sz"], [0.0],
                     False),
    "three_spin10": (lambda: tz.three_spin_chain_with(
        tz.Lattice, tz.Model, tz.Opr, tz.Mopr, 10, device="cpu"), ["Sz"],
        [0.0], True),
}
_BUILT: dict = {}


def _model(name):
    if name not in _BUILT:
        build, names, vals, _ = MODELS[name]
        m, ops = build()
        m.enumerate_basis_full([ops[c] for c in names], vals)
        _BUILT[name] = m
    return _BUILT[name]


def _sz_q(L, q):
    """Sz(q) = sum_s exp(i q s) Sz_s / sqrt(L): complex diagonal terms."""
    out = Mopr()
    for s in range(L):
        out += (np.exp(1j * q * s) / np.sqrt(L)) * Opr(s, 0, False,
                                                       tz.SP_HALF["Sz"])
    return out


def _cols(compiled):
    """(D, slots) of every image column in pack_rows' order."""
    out = []
    for g in compiled.groups:
        T, D, K = g.dlt.shape
        for t in range(T):
            out += [(D, [int(s) for s in g.slots[t]])] * K
    return out


def _words(tabs):
    """Words 0 and 1 of every record, as non-negative int64."""
    return (tabs.rec[:, 0].long() & 0xFFFFFFFF,
            tabs.rec[:, 1].long() & 0xFFFFFFFF)


def _packed_images(tabs, labels, V, fodd):
    """(amp * sign, target) of every row and column from the packed fields
    alone, as the kernels compute them: the joint column from record word 1
    (label bit fields or V), the entry from ``ad`` at word 0's offset, the
    sign from the record's wmask, a diagonal column's target the row's own
    label."""
    E = tabs.n_cols
    w0, w1 = _words(tabs)
    lab = labels.long()[:, None]
    if tabs.bits:
        m0 = (w1 >> 16) & 255
        v0 = (lab >> (w1 & 63)) & m0
        v1 = (lab >> ((w1 >> 8) & 63)) & (w1 >> 24)
        c = v0 + v1 * (m0 + 1)
    else:
        c = V.long()[:, w1 & 255] + V.long()[:, (w1 >> 8) & 255] \
            * ((w1 >> 16) & 255)
    gen = (w0 >> 31) & 1 == 1
    if gen.any():
        sel = tabs.gsel.long()
        if tabs.bits:
            vals = (lab[:, :, None] >> (sel & 63)) & (sel >> 8)
        else:
            vals = V.long()[:, sel]
        cg = (vals * tabs.strides.long()).sum(-1)
        c = torch.where(gen, cg, c)
    idx = (w0 & ((1 << 28) - 1)) + c
    ad = tabs.ad[idx]                                   # (rows, E, W)
    if tabs.is_complex:
        amp = torch.complex(ad[..., 0].view(torch.float64),
                            ad[..., 1].view(torch.float64))
        dlt = ad[..., 2]
    else:
        amp = ad[..., 0].view(torch.float64)
        dlt = ad[..., 1]
    wm = (tabs.rec[:, 2].long() & 0xFFFFFFFF) | (tabs.rec[:, 3].long() << 32)
    if fodd is not None:
        amp = amp * (1 - 2 * _parity(fodd[:, None] & wm)).double()
    diag = (w0 >> 30) & 1 == 1
    tgt = torch.where(diag, lab.expand(-1, E), lab + dlt)
    assert tuple(tgt.shape) == (labels.numel(), E)
    return amp, tgt


@pytest.mark.parametrize("name", sorted(MODELS))
def test_label_bit_fields_give_the_slot_values(name):
    """Every column's record bit fields (and, at arity > 2, its selectors)
    read V[:, slots] from the labels on every row; none where a dim is not
    a power of two, whose records hold the slots themselves."""
    m = _model(name)
    tabs = pack_rows(m.compiled_Ham, "cpu")
    assert tabs.bits == MODELS[name][3]
    assert (slot_bit_fields(m.space) is not None) == tabs.bits
    db = m.sec_full[0].dbasis
    labels = db.labels_b.view(-1)[: db.n]
    V = db.V_b.view(-1, m.space.n_slots)[: db.n].long()
    w0, w1 = _words(tabs)
    for e, (D, slots) in enumerate(_cols(m.compiled_Ham)):
        a, w = int(w0[e]), int(w1[e])
        assert (e < tabs.n_simple) == (len(slots) <= 2)
        if len(slots) > 2:
            assert a >> 31 == 1
            sel = tabs.gsel[e, : len(slots)].tolist()
        else:
            assert a >> 31 == 0
            if tabs.bits:        # (shift | mask << 8) of each slot
                sel = [(w & 255) | ((w >> 16) & 255) << 8,
                       ((w >> 8) & 255) | (w >> 24) << 8][: len(slots)]
                if len(slots) == 1:
                    assert w >> 24 == 0
            else:
                sel = [w & 255, (w >> 8) & 255][: len(slots)]
                assert ((w >> 16) & 255) == (int(m.space.dims[slots[0]])
                                             if len(slots) == 2 else 0)
        for s, se in zip(slots, sel):
            if tabs.bits:
                got = (labels >> (se & 63)) & (se >> 8)
            else:
                assert se == s
                got = V[:, se]
            torch.testing.assert_close(got, V[:, s], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_interleaved_entries_equal_the_flat_tables(name):
    """ad[rec.off + c] = (amp, dlt)[off + c * kstr] for every column and
    every joint column c of its group; the diagonal flag is set exactly
    where every dlt entry of the column is 0."""
    m = _model(name)
    tabs = pack_rows(m.compiled_Ham, "cpu")
    assert tabs.ad.shape == (tabs.dlt.numel(), 4 if tabs.is_complex else 2)
    for e, (D, _) in enumerate(_cols(m.compiled_Ham)):
        c = torch.arange(D)
        flat = tabs.off[e].long() + c * tabs.kstr[e].long()
        ad = tabs.ad[(int(tabs.rec[e, 0]) & ((1 << 28) - 1)) + c]
        if tabs.is_complex:
            amp = torch.complex(ad[:, 0].view(torch.float64),
                                ad[:, 1].view(torch.float64))
            assert (ad[:, 3] == 0).all()
        else:
            amp = ad[:, 0].view(torch.float64)
        torch.testing.assert_close(amp, tabs.amp[flat].to(amp.dtype),
                                   rtol=0, atol=0)
        dlt = ad[:, 2 if tabs.is_complex else 1]
        torch.testing.assert_close(dlt, tabs.dlt[flat], rtol=0, atol=0)
        assert bool(tabs.diagonal[e]) == bool((dlt == 0).all())
    wm = (tabs.rec[:, 2].long() & 0xFFFFFFFF) | (tabs.rec[:, 3].long() << 32)
    want = tabs.wmask if tabs.wmask is not None else torch.zeros_like(wm)
    torch.testing.assert_close(wm, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_images_equal_the_plain_images(name):
    """The images the kernels compute from rec / ad / gsel equal the plain
    version's (amplitude with its sign, target label) on every row."""
    m = _model(name)
    tabs = pack_rows(m.compiled_Ham, "cpu")
    db = m.sec_full[0].dbasis
    n = db.n
    labels = db.labels_b.view(-1)[:n]
    V = db.V_b.view(-1, m.space.n_slots)[:n]
    fodd = None if db.fodd is None else db.fodd[:n]
    amp, tgt = _row_images(tabs, labels, V, fodd)
    pamp, ptgt = _packed_images(tabs, labels, V, fodd)
    torch.testing.assert_close(pamp, amp, rtol=0, atol=0)
    live = amp != 0           # a zero amplitude's target is never read
    torch.testing.assert_close(ptgt[live], tgt[live], rtol=0, atol=0)
    assert live.any()


def test_sz_q_columns_all_diagonal():
    """Sz(q) on chain-24 packs one column a site whose phase is not real
    (22 at q = 2 pi 5 / 24; the two real ones join the real diagonal), every
    one diagonal (all dlt 0) with complex amplitudes; <Sz0 Sz1> has none
    (it is the real diagonal); the chain's Hamiltonian none either (its
    images flip two spins)."""
    m, ops = tz.heisenberg_chain(24)
    q = 2 * np.pi * 5 / 24
    tabs = pack_rows(m.compile_op(_sz_q(24, q)), "cpu")
    complex_sites = int((np.abs(np.sin(q * np.arange(24))) > 1e-12).sum())
    assert complex_sites == 22
    assert tabs.n_cols == complex_sites and tabs.is_complex and tabs.bits
    assert bool(tabs.diagonal.all()) and not bool(tabs.dlt.any())
    assert pack_rows(m.compile_op(tz.sz_pair(0, 1)), "cpu").n_cols == 0
    h = pack_rows(m.compiled_Ham, "cpu")
    assert h.n_cols == 24 and not bool(h.diagonal.any())
    assert h.nbytes == 16 * 24 + 16 * h.dlt.numel()


@pytest.mark.parametrize("mode", MODES)
def test_mopr_x_vec_sz_q_matches_jax(mode):
    """Sz(q) (complex amplitudes, every column diagonal) within Sz=0 on
    chain-10, real and complex vectors, the destination's index in
    ``mode``, against the JAX package's mopr_x_vec (1e-12)."""
    import models_zoo as jz
    import quantum_basis_tpu as qj
    from quantum_basis_tpu.ops.apply import mopr_x_vec as jax_mopr_x_vec

    L, q = 10, 2 * np.pi * 3 / 10
    mj, oj = jz.heisenberg_chain(L)
    mt, ot = tz.heisenberg_chain(L)
    mj.enumerate_basis_full([oj["Sz"]], [0.0])
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    st = mt.sec_full[0]
    ix = BasisIndex(st.labels, mt.space.label_space, mode=mode,
                    lin_split=digit_split(mt.space), device="cpu")
    assert ix.mode == mode
    dst = DeviceBasis(mt.space, st.labels, ix, block_rows=64, device="cpu")
    szq_j = Mopr_of(qj, L, q)
    op_t = mt.compile_op(_sz_q(L, q))
    assert bool(pack_rows(op_t, "cpu").diagonal.all())
    for vec in ("real", "complex"):
        rng = np.random.default_rng(4)
        re = rng.standard_normal(st.dim)
        im = rng.standard_normal(st.dim) if vec == "complex" else None
        yr, yi = jax_mopr_x_vec(mj.compile_op(szq_j), mj.sec_full[0].dbasis,
                                mj.sec_full[0].dbasis, (re, im))
        ap.scatter_launch_count = 0
        y = mopr_x_vec(op_t, st.dbasis, dst, vec_from_split(re, im,
                                                           device="cpu"))
        assert ap.scatter_launch_count == 0
        tr, ti = vec_to_split(y)
        np.testing.assert_allclose(tr, np.asarray(yr), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ti, np.asarray(yi), rtol=0, atol=1e-12)


def Mopr_of(pkg, L, q):
    """Sz(q) built with the given package's classes."""
    out = pkg.Mopr()
    for s in range(L):
        out += (np.exp(1j * q * s) / np.sqrt(L)) * pkg.Opr(
            s, 0, False, tz.SP_HALF["Sz"])
    return out


def test_int32_position_table_gives_int64_rows():
    """A direct index holds its position table with int32 rows; it looks
    labels up to the same int64 rows as a reference table of int64 rows,
    every basis label to its own row."""
    m = _model("chain12")
    st = m.sec_full[0]
    ix = BasisIndex(st.labels, m.space.label_space, mode="direct",
                    device="cpu").tables
    assert ix.t0.dtype == torch.int32
    ix64 = ix._replace(t0=ix.t0.long())
    labels = torch.as_tensor(st.labels)
    torch.testing.assert_close(lookup_tables(ix, labels),
                               torch.arange(ix.n), rtol=0, atol=0)
    for t in (labels, labels[::3] + 1):
        got = lookup_tables(ix, t)
        assert got.dtype == torch.int64
        torch.testing.assert_close(got, lookup_tables(ix64, t), rtol=0,
                                   atol=0)
