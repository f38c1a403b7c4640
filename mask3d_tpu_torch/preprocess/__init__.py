"""Host-side preprocessing that the baseline reads (a subset of
mask3d_tpu/preprocess)."""
