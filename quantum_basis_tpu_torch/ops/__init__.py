"""Operator algebra, term compiler, momentum-sector apply, ELL and BSR."""
