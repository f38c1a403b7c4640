"""Sparse-voxel levels, the dense-grid pyramid and ops, the row gather."""
