"""Test harnesses of the port: the single-chip chaos harness."""
