"""The work the rooflines and ``mfu`` divide by, counted on the reference."""
