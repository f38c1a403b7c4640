"""Sparse-voxel levels, kernel maps and PoolMaps, the dense-grid pyramid
and ops, the row-space ops of the gather path, the row gather, the sparse
gather-conv, and the int8 eval convs with the fused int8 block chain."""
