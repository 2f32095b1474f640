"""Stretching: the screen transfer function (STF)."""
