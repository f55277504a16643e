"""Neighbor grid, the fields6 layout and the hand-written kernels."""
