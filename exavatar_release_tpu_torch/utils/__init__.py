"""Logging, timing, image and video output for the apps; profiling."""
from .logging import Timer, make_logger

__all__ = ["Timer", "make_logger"]
