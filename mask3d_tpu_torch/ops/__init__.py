"""Masked cross-attention and furthest-point sampling."""
