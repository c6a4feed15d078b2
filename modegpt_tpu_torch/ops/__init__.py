"""Solver linear algebra: PSD roots, Cholesky solves, allocation, Type-I/II/III solves, RoPE."""
