"""Hand-written Hopper kernels of the port and their plain versions."""
