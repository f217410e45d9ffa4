"""3D Gaussian rasterizer: projection, binning, CUDA compositing kernels."""
from .api import RasterizeSettings, rasterize

__all__ = ["RasterizeSettings", "rasterize"]
