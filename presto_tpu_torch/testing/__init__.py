"""Test harnesses of the port that run wherever the port runs (no pandas,
no JAX): the sqlite oracle for TPC-H."""
