"""Thick-restart Lanczos and the mixed-precision RQI polish."""
