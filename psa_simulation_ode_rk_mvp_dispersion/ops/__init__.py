"""Core numerical operations: frequency plans, dispersion,
phase matching, the FWM RHS, and scan-based integrators."""
