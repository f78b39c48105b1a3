"""The reference's single-map rank on the port's batched ops.

The reference's per-map ops take one map (or one image) and its pipeline
``vmap``s them; the port's are written batched. ``one_or_batch`` lets a
batched function take both ranks without a second code path.
"""
from __future__ import annotations

import functools


def one_or_batch(shape: str, *batched: str):
    """Decorator for a function whose leading parameters ``batched`` carry
    a batch axis first. ``shape`` names the dims of one map of the first
    (``"H, W"``, ``"H, W, 3"``).

    A first argument of that rank is viewed as a batch of one, as are the
    other ``batched`` arguments (``x[None]``, no copy); the batched
    function runs unchanged and every output drops its leading axis (each
    entry of a dict). A batch goes straight through. Any other rank
    raises ``ValueError`` naming the two ranks taken.
    """
    rank = shape.count(",") + 1

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            x = args[0] if args else kw[batched[0]]
            if x.dim() == rank + 1:
                return fn(*args, **kw)
            if x.dim() != rank:
                raise ValueError(
                    f"{fn.__name__}: {batched[0]} must be [{shape}] (one map) "
                    f"or [B, {shape}] (a batch), got {tuple(x.shape)}")
            args = tuple(a[None] if i < len(batched) else a
                         for i, a in enumerate(args))
            kw = {k: v[None] if k in batched else v for k, v in kw.items()}
            out = fn(*args, **kw)
            if isinstance(out, dict):
                return {k: v[0] for k, v in out.items()}
            return out[0]
        return call
    return wrap
