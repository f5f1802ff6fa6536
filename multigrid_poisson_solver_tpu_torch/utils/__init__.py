"""Utilities (solution I/O)."""
