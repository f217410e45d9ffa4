"""The general generators of the traffic mixes: a mix's data file names
its driver (``"driver"``) and gives every parameter it reads."""
