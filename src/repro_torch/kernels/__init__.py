"""Hand-written Hopper kernels, their wrappers and plain versions."""
