"""Sigma-clipped stacking and the fused shift+clip kernel."""
