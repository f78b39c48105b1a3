"""Training-side modules of the port: the DB loss and label maps, the
detector, CRNN and TrOCR trainers and their CLIs, and checkpoints (the
port's own ``.pt`` state dicts, and the JAX package's read without JAX,
``checkpoint.restore_variables``).

The names below are imported on first use, not with the package: the
serving path imports ``train.checkpoint``, and has no use for the
trainer's imports (the mesh, the data-parallel helpers) on a worker's
cold start.
"""
_EXPORTS = {
    "bce_loss": "losses",
    "dice_loss": "losses",
    "db_loss": "losses",
    "ModelTrainer": "trainer",
    "TextDetectionDataset": "trainer",
    "create_train_state": "trainer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        from importlib import import_module

        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
