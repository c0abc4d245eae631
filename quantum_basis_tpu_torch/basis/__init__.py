"""State spaces, enumeration, index and translation orbits."""
