"""Tensor ops: triplane sampling, KNN, and the 3DGS rasterizer."""
