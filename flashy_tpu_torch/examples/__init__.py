"""Solvers built on the port's harness (the counterparts of examples/)."""
