"""Offline dataset preparation, on the host in numpy: a copy of
mask3d_tpu/preprocess (reference `datasets_preprocess/`):

- `stru3d`      — Structured3D panorama -> labelled point cloud
- `png`         — the depth maps' PNG reader and writer (no OpenCV)
- `downsample`  — voxel-grid downsampling of .ply clouds
- `matterport`  — Matterport3D region merge and download driver
- `geometry`    — vectorized polygon ops (shapely replacement)
- `analyze`     — dataset statistics reports

Each with a command line: `python -m mask3d_tpu_torch.preprocess.<module>`
(`png` and `geometry` have none).
"""
