"""Sparse containers, the SpKAdd family, and the regime engine."""
