"""Training-side modules of the port. So far: reading the JAX package's
checkpoints (``checkpoint.restore_variables``)."""
