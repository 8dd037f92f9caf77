"""Microbenchmarks of the port, each the counterpart of one in the repo's ``benchmarks/``."""
