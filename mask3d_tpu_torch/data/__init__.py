"""Input path: synthetic scenes, voxelizing collation, batch containers."""
