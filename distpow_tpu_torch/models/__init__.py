"""Puzzle semantics, the MD5 model and the hash-model registry."""
