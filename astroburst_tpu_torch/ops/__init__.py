"""Primitives: validity mask, FFT helpers, resampling, stats, crops."""
