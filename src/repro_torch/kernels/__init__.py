"""Hand-written Hopper kernels, their wrappers and plain versions
(port of ``repro.kernels``)."""
