"""Neural-net layers of the avatar MLP heads."""
from .mlp import MLP

__all__ = ["MLP"]
