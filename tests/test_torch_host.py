"""Port host layer (quantum_basis_tpu_torch) against the JAX package.

The numpy host code — operator algebra, lattices, state codec, term
compiler, Lehmer starts — is carried into the port; the compiled term tables
of each model must be array-equal to the JAX package's.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.ops.compile import compile_diagonal as jax_compile_diagonal
from quantum_basis_tpu.utils.rng import vec_randomize as jax_vec_randomize
from quantum_basis_tpu_torch.ops.compile import compile_diagonal
from quantum_basis_tpu_torch.utils.rng import vec_randomize

MODELS = {
    "chain8": (lambda z: z.heisenberg_chain(8)),
    "kagome_tj_1x2": (lambda z: z.kagome_tj(1, 2)),
    "honeycomb_3x2": (lambda z: z.spinless_fermion_honeycomb(3, 2)),
    "kondo4": (lambda z: z.kondo_chain(4, 4.0)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_compiled_term_tables_equal(name):
    mj, _ = MODELS[name](jz)
    mt, _ = MODELS[name](tz)
    cj, ct = mj.compiled_Ham, mt.compiled_Ham
    assert ct.nnz_per_row == cj.nnz_per_row
    assert len(ct.groups) == len(cj.groups)
    for gj, gt in zip(cj.groups, ct.groups):
        assert gt.arity == gj.arity
        for attr in ("slots", "jstrides", "dlt", "amp_re", "W"):
            np.testing.assert_array_equal(getattr(gt, attr), getattr(gj, attr))
        assert (gt.amp_im is None) == (gj.amp_im is None)
        if gj.amp_im is not None:
            np.testing.assert_array_equal(gt.amp_im, gj.amp_im)
    # the diagonal part, evaluated on every label of the space
    space = mt.space
    labels = np.arange(space.label_space, dtype=np.int64)
    V = space.decode(labels)
    np.testing.assert_array_equal(V, mj.space.decode(labels))
    dj = jax_compile_diagonal(cj.diag_terms, mj.space)(V)
    np.testing.assert_array_equal(
        compile_diagonal(ct.diag_terms, space)(V), dj)
    # the torch path of the same evaluator and of the codec
    Vt = space.decode(torch.as_tensor(labels))
    np.testing.assert_array_equal(Vt.numpy(), V)
    np.testing.assert_array_equal(space.encode(Vt).numpy(), labels)
    np.testing.assert_array_equal(
        compile_diagonal(ct.diag_terms, space)(Vt).numpy(), dj)


@pytest.mark.parametrize("name", ["kagome_tj_1x2", "honeycomb_3x2"])
def test_translation_plans_equal(name):
    mj, _ = MODELS[name](jz)
    mt, _ = MODELS[name](tz)
    dj, pj = mj.lattice.translation_group()
    dt, pt = mt.lattice.translation_group()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    for plan in pt:
        for a, b in zip(mt.space.permutation_arrays(plan),
                        mj.space.permutation_arrays(plan)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("complex_valued", [False, True])
def test_random_start_equal(complex_valued):
    for a, b in zip(vec_randomize(1000, seed=3, complex_valued=complex_valued),
                    jax_vec_randomize(1000, seed=3,
                                      complex_valued=complex_valued)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    mods = ["quantum_basis_tpu_torch", "quantum_basis_tpu_torch.interop",
            "quantum_basis_tpu_torch.lattice.tilted",
            "quantum_basis_tpu_torch.basis.weisse",
            "quantum_basis_tpu_torch.basis.io",
            "quantum_basis_tpu_torch.utils.ckpt",
            "quantum_basis_tpu_torch.ops.translate_fullspace",
            "quantum_basis_tpu_torch.solvers.cg",
            "quantum_basis_tpu_torch.solvers.kpm",
            "quantum_basis_tpu_torch.postprocess",
            "quantum_basis_tpu_torch.basis.vrnl",
            "quantum_basis_tpu_torch.basis.wavefunction",
            "quantum_basis_tpu_torch.ops.apply_vrnl",
            "quantum_basis_tpu_torch.utils.profiling",
            "quantum_basis_tpu_torch.parallel",
            "quantum_basis_tpu_torch.parallel.fullspace_sharded",
            "quantum_basis_tpu_torch.parallel.kron_sharded",
            "quantum_basis_tpu_torch.solvers.reduce"]
    # every module of the drivers' subpackages
    import pkgutil

    import quantum_basis_tpu_torch.benchmarks as bench
    import quantum_basis_tpu_torch.examples as ex

    for pkg in (ex, bench):
        mods += [pkg.__name__] + [
            info.name for info in pkgutil.iter_modules(pkg.__path__,
                                                       pkg.__name__ + ".")]
    code = (f"import sys, {', '.join(mods)}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'quantum_basis_tpu')]; assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_device_defaults_are_cuda():
    """Every ``device`` parameter of the port is required or defaults to
    "cuda": nothing picks the CPU on its own."""
    import importlib
    import inspect
    import pkgutil

    import quantum_basis_tpu_torch as pkg

    seen = 0
    names = set()
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [obj] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [getattr(f, "__func__", f) for f in vars(obj).values()]
            for f in fns:
                if not inspect.isfunction(f):
                    continue
                p = inspect.signature(f).parameters.get("device")
                if p is not None:
                    seen += 1
                    names.add(f"{info.name}.{f.__qualname__}")
                    assert p.default in ("cuda", inspect.Parameter.empty), \
                        (info.name, f.__qualname__, p.default)
    assert seen > 20
    # the basis mesh and its start-up (parallel/*) are among them
    par = "quantum_basis_tpu_torch.parallel."
    assert {par + "mesh.BasisMesh.__init__", par + "mesh.basis_mesh",
            par + "distributed.init_distributed",
            par + "distributed.global_basis_mesh"} <= names


def test_phase_timer_and_trace(tmp_path):
    from quantum_basis_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
    from quantum_basis_tpu_torch.utils.profiling import PhaseTimer, trace

    lines, jax_lines = [], []
    for cls, out in ((PhaseTimer, lines), (JaxPhaseTimer, jax_lines)):
        pt = cls(printer=out.append)
        for _ in range(2):
            with pt.phase("apply"):
                pass
        with pt.phase("solve", verbose=True):
            pass
        pt.report()
        assert pt.counts == {"apply": 2, "solve": 1}
        assert all(t >= 0.0 for t in pt.times.values())
    assert [ln.split()[0] for ln in lines] == [ln.split()[0]
                                               for ln in jax_lines]
    assert lines[0].startswith("[solve]") and "(x2)" in "".join(lines)
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, dtype=torch.float64).cumsum(0).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_unported_options_raise():
    """Checkpointing, the streaming enumeration, dynamics, interior windows,
    the variational sector and the basis mesh are ported: none of them
    raises NotImplementedError; a mesh that is not a BasisMesh is refused
    with a TypeError."""
    from quantum_basis_tpu_torch import Lattice, Model, config

    try:
        config.initialize(enable_checkpoint=True, quiet=True)
        assert config.enable_ckpt is True
    finally:
        config.initialize(enable_checkpoint=False, quiet=True)
    assert config.enable_ckpt is False
    m, _ = tz.heisenberg_chain(4)
    assert m.enumerate_basis_repr([0], method="dnc") == 6
    m.build_basis_vrnl([1], 0, [0.0], [0.25], 2)
    m.locate_E0_lanczos(which="vrnl")
    assert m.dim_vrnl() == 1 and len(m.eigenvals_vrnl) == 1
    m.locate_E0_lanczos(which="repr")
    nrm, alphas, betas = m.measure_repr_dynamic(
        m.symmetrize_op(tz.sz_pair(0, 1)), 0, 0, 3)
    assert nrm > 0 and alphas.shape == betas.shape == (3,)
    assert m.locate_Es(-3.0, 1.0, which="repr", nev_max=6, degree=40)
    with pytest.raises(TypeError, match="BasisMesh"):
        Model(Lattice("chain", [4], ["pbc"]), device="cpu", mesh=object())
    with pytest.raises(TypeError, match="BasisMesh"):
        tz.hubbard_factorized(2, 2)[0].set_mesh(object())
