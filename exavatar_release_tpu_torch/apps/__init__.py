"""Applications on the avatar: motion rendering and the training loop."""
