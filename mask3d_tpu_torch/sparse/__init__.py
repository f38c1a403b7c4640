"""Sparse-voxel levels, kernel maps and PoolMaps, the dense-grid pyramid
and ops, the row-space ops of the gather path, the row gather and the
sparse gather-conv."""
