"""Training-side modules of the port: the DB loss and label maps, the
detector, CRNN and TrOCR trainers and their CLIs, and checkpoints (the
port's own ``.pt`` state dicts, and the JAX package's read without JAX,
``checkpoint.restore_variables``)."""
