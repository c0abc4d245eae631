"""Lattice geometry and symmetry plans."""
