"""Res16UNet backbones, positional encodings and the Mask3D model."""
