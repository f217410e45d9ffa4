"""Rotations, cameras and geometry on torch tensors."""
