"""Checkpoints of the port: save its own torch-format state dicts, and
restore the JAX package's checkpoints without JAX (port of
``vtd_tpu/train/checkpoint.py``).

``save_state_dict(path, model)`` writes the port's format, a ``.pt``
state dict, which every loader of the port takes (``load_weights``).

``restore_variables(path)`` returns the variables tree as nested dicts of
numpy arrays, keyed exactly as the reference's restore keys it. It reads

  * a directory (or a file) holding a pickled ``variables.pkl``, and
  * an orbax OCDBT directory, through the port's own reader
    (``train/ocdbt.py``): the nesting comes from the key tuples of
    ``_METADATA["tree_metadata"]``, each leaf from the zarr array named
    by its keys joined with dots.

bfloat16 leaves are widened exactly to float32; ``stored_dtypes(path)``
names each leaf's stored dtype so that a caller can ask for bf16 back
(``to_torch``).
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .ocdbt import OcdbtStore, read_zarr

_DICT_KEY = 2  # orbax's key_type of a dict key


# Packages the port never imports; a pickle naming one of them is refused
# before ``find_class`` would import it.
_BANNED = frozenset(
    ("jax", "jaxlib", "flax", "orbax", "tensorstore", "vtd_tpu"))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _BANNED:
            raise RuntimeError(
                f"unpickling the checkpoint needs module {module!r} "
                f"({name}), which the port never imports"
            )
        try:
            return super().find_class(module, name)
        except ImportError as e:
            raise RuntimeError(
                f"unpickling the checkpoint needs module {module!r} "
                f"({name}), which the port does not have or import"
            ) from e


def _widen(tree: Any) -> Any:
    """bfloat16 numpy leaves of a pickled tree -> float32 (exact)."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return tree.astype(np.float32)
    return tree


def _restore_pickle(path: Path) -> Any:
    with open(path, "rb") as fh:
        return _widen(_Unpickler(fh).load())


def _tree_metadata(path: Path) -> List[Tuple[str, ...]]:
    """The leaves' key tuples from ``_METADATA``, in its order."""
    meta = json.loads((path / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: zarr3 checkpoints are not read")
    out = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if any(int(k["key_type"]) != _DICT_KEY for k in keys):
            raise NotImplementedError(
                f"{path}: a tree with other than dict keys")
        out.append(tuple(str(k["key"]) for k in keys))
    return out


def _nest(leaves: Dict[Tuple[str, ...], Any]) -> Dict:
    """Flat {key tuple: leaf} -> nested dicts."""
    root: Dict = {}
    for keys, leaf in leaves.items():
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return root


def _read_orbax(path: Path) -> Dict:
    store = OcdbtStore(path)
    return _nest({
        keys: read_zarr(store, ".".join(keys))[0]
        for keys in _tree_metadata(path)
    })


def _checkpoint_kind(path: Path) -> Tuple[str, Path]:
    if path.is_dir():
        if (path / "variables.pkl").exists():
            return "pickle", path / "variables.pkl"
        if (path / "_METADATA").exists():
            return "orbax", path
        raise FileNotFoundError(f"No checkpoint at {path}")
    if path.is_file():
        return "pickle", path
    raise FileNotFoundError(f"No checkpoint at {path}")


def restore_variables(path: str | Path) -> Any:
    """The variables tree of a checkpoint directory (orbax or
    ``variables.pkl``) or of a pickle file, as numpy arrays; bfloat16
    leaves widened to float32."""
    kind, where = _checkpoint_kind(Path(path))
    if kind == "pickle":
        return _restore_pickle(where)
    return _read_orbax(where)


def save_state_dict(path: str | Path, model: torch.nn.Module) -> str:
    """Write ``model``'s state dict to ``path`` (a ``.pt`` file; its
    directory is made), its tensors on the CPU; returns the path. The
    file is written under a temporary name and renamed, so a kill during
    the save leaves any earlier file at ``path`` whole."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = p.with_name(p.name + ".tmp")
    torch.save(sd, tmp)
    os.replace(tmp, p)
    return str(p)


def load_state_dict(path: str | Path) -> dict:
    """A torch-format checkpoint of the port (a state dict, or a dict
    holding one under ``model_state_dict``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model_state_dict", sd)


def is_torch_file(path: str | Path) -> bool:
    """A ``.pth``/``.pt`` name, or a file that opens as a zip archive
    (what ``torch.save`` writes, whatever the name)."""
    p = Path(path)
    if p.suffix in (".pth", ".pt"):
        return True
    if not p.is_file():
        return False
    with open(p, "rb") as fh:
        return fh.read(4) == b"PK\x03\x04"


def load_weights(
    path: str | Path, from_jax: Callable[..., Dict[str, torch.Tensor]], *args
) -> Dict[str, torch.Tensor]:
    """A model's state dict from any checkpoint the reference's loaders
    take: a torch file (:func:`is_torch_file`), or the JAX package's
    variables (an orbax directory, a directory or file holding a pickled
    ``variables.pkl``) carried across by ``from_jax``."""
    if is_torch_file(path):
        return load_state_dict(path)
    return from_jax(restore_variables(path), *args)


def stored_dtypes(path: str | Path) -> Dict[Tuple, str]:
    """{key tuple: stored dtype name} of an orbax checkpoint's leaves
    (read from each array's ``.zarray``; no array data is read)."""
    kind, where = _checkpoint_kind(Path(path))
    if kind == "pickle":
        raise ValueError(f"{path}: a pickle keeps its own dtypes")
    store = OcdbtStore(where)
    out = {}
    for keys in _tree_metadata(where):
        meta = json.loads(store.get(f"{'.'.join(keys)}/.zarray".encode()))
        dt = meta["dtype"]
        out[keys] = dt if dt == "bfloat16" else np.dtype(dt).name
    return out


def to_torch(tree: Any, dtypes: Dict[Tuple, str] | None = None,
             _path: Tuple = ()) -> Any:
    """numpy tree -> torch tensors; leaves named bfloat16 in ``dtypes``
    (from :func:`stored_dtypes`) go back to ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtypes, _path + (str(k),))
                for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if dtypes is not None and dtypes.get(_path) == "bfloat16":
        t = t.to(torch.bfloat16)
    return t
