"""Read an orbax checkpoint directory into a nested dict of numpy arrays.

The reference's own loader: the variables tree as the JAX package saved
it (flax names and layouts, ``params`` and ``batch_stats``), read with
the frozen OCDBT reader beside this file. bfloat16 leaves come back as
float32, exactly.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from .ocdbt import OcdbtStore, read_zarr

_DICT_KEY = 2  # orbax's key_type of a dict key


def _tree_keys(path: Path) -> List[Tuple[str, ...]]:
    meta = json.loads((path / "_METADATA").read_text())
    out = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if any(int(k["key_type"]) != _DICT_KEY for k in keys):
            raise NotImplementedError(f"{path}: a tree with other than dict keys")
        out.append(tuple(str(k["key"]) for k in keys))
    return out


def read_variables(path: str) -> Dict:
    """The nested variables dict of the orbax checkpoint at ``path``."""
    where = Path(path)
    store = OcdbtStore(where)
    root: Dict = {}
    for keys in _tree_keys(where):
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = read_zarr(store, ".".join(keys))[0]
    return root
