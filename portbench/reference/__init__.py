"""Plain PyTorch references of what the cells' calls compute.

Nothing here imports the program, JAX or the JAX package, or calls a
kernel of the program: each reference works from the benchmark's own
inputs (genotype codes drawn from the seed, phenotypes, covariates,
probes, model arrays) and computes in the dtype it is given, float64 for
the reference and float32 for the control."""
