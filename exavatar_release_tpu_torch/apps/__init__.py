"""Applications on the avatar: motion rendering."""
