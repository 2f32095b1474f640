"""Alignment: phase correlation (kernels K1, K2), star-based affine
alignment (kernel K12) and the pairwise API."""
