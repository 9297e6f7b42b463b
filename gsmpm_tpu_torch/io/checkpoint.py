"""Full-state checkpoint / resume: the port of gsmpm_tpu/io/checkpoint.py.

A tree of tensors (here ``(MPMState, MPMModel, t_sim)``) round-trips
through one compressed ``.npz`` per step plus a JSON manifest, both written
through a ``.tmp`` file and ``os.replace``.  The layout is the JAX
module's: ``<dir>/step_%08d.ckpt.npz`` holding ``leaf_0 .. leaf_{n-1}``
and ``<dir>/manifest.json`` with ``latest_step``, ``treedef``, ``n_leaves``
and ``extra``.

The tree is flattened by hand in the order ``jax.tree_util`` uses for the
JAX package's registered dataclasses: tuples and lists item by item,
dataclasses field by field in declaration order with only their tensor
fields as leaves (the other fields, e.g. ``MPMModel.hardening``, are kept
from the template, as the JAX dataclasses' static fields are), and a bare
number as a 0-d leaf.  So the two packages read each other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


_LEAF = (torch.Tensor, np.ndarray, float, int, np.floating, np.integer)


def _flatten(tree, leaves: list) -> str:
    """Append tree's leaves (tensors, arrays, numbers) to leaves; returns a
    structure string."""
    if isinstance(tree, _LEAF):
        leaves.append(tree)
        return "*"
    if dataclasses.is_dataclass(tree):
        parts = [f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                 for f in dataclasses.fields(tree)
                 if isinstance(getattr(tree, f.name), torch.Tensor)]
        return f"{type(tree).__name__}({', '.join(parts)})"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(t, leaves) for t in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    # a bare float is the float32 clock, as the JAX app keeps it
    return np.asarray(leaf, np.float32 if isinstance(leaf, float) else None)


def _unflatten(template, leaves):
    """Rebuild template's structure from an iterator of numpy leaves."""
    if isinstance(template, torch.Tensor):
        arr = next(leaves)
        if arr.shape != tuple(template.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape}, template "
                             f"{tuple(template.shape)}: structure mismatch")
        return torch.from_numpy(np.array(arr)).to(device=template.device,
                                                  dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.floating, np.integer)):
        return np.asarray(next(leaves), template.dtype)
    if isinstance(template, (float, int)):
        return type(template)(next(leaves))
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)
            if isinstance(getattr(template, f.name), torch.Tensor)})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    raise TypeError(f"cannot restore a {type(template).__name__}")


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Write ``tree`` (+ JSON-serializable ``extra``) as step's checkpoint."""
    os.makedirs(directory, exist_ok=True)
    leaves: list = []
    structure = _flatten(tree, leaves)
    path = os.path.join(directory, f"step_{step:08d}.ckpt.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **{f"leaf_{i}": _to_numpy(l)
                                  for i, l in enumerate(leaves)})
    os.replace(tmp, path)

    manifest = {
        "latest_step": step,
        "treedef": structure,
        "n_leaves": len(leaves),
        "extra": extra or {},
    }
    man_tmp = os.path.join(directory, "manifest.json.tmp")
    with open(man_tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(man_tmp, os.path.join(directory, "manifest.json"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """Highest step with a checkpoint file present, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for fn in os.listdir(directory)
        if (m := re.match(r"step_(\d+)\.ckpt\.npz$", fn))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template,
                       step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore (tree, step, extra); ``template`` supplies the structure, the
    non-tensor fields and each tensor's device and dtype.

    Raises FileNotFoundError if no checkpoint exists and ValueError when
    the file's leaves do not fit the template.
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}.ckpt.npz")
    template_leaves: list = []
    _flatten(template, template_leaves)
    n_template = len(template_leaves)
    with np.load(path) as data:
        if n_template != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template has "
                f"{n_template} — structure mismatch"
            )
        leaves = [data[f"leaf_{i}"] for i in range(n_template)]
    tree = _unflatten(template, iter(leaves))
    extra = {}
    man_path = os.path.join(directory, "manifest.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            extra = json.load(f).get("extra", {})
    return tree, step, extra

