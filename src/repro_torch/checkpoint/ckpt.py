"""Tree checkpointing to .npz, in the JAX package's file format.

A tree is nested dicts, NamedTuples, dataclasses, lists and tuples with
tensors (or numpy arrays) at the leaves.  Leaves are flattened with
'/'-joined key paths named as ``jax.tree_util`` names them: a dict entry by
its key (dicts in sorted-key order), a NamedTuple or dataclass field as
``.<field>``, a list or tuple entry by its index.  So a checkpoint of the
port and one of the JAX package name a leaf both hold alike (``fleet/
.twins/.loss``, ``fleet/.cluster_params/w1``, ``times``), and each package
reads the other's.  Tensors are copied to the host before they are written.

Two leaf kinds carry a marker in the file, as in the JAX package:

* bfloat16 leaves store as f32 under a ``__bf16__:`` key prefix;
* ``__key__:<impl>:<path>`` holds a typed JAX PRNG key's raw data.  The
  port never writes one: its draws are a function of (seed, round, device)
  and it saves no key.  `typed_key_leaves` finds them in a JAX package
  checkpoint, whose random stream the port cannot continue.

Writes are crash-safe: the archive lands under a ``.tmp`` name, is
``fsync``-ed and ``os.replace``-d into place, so a reader (or a resume
after a mid-write crash) never sees a torn checkpoint file.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Tuple

import numpy as np
import torch

_BF16 = "__bf16__:"
_KEY = "__key__:"


def _children(node) -> List[Tuple[str, Any]] | None:
    """``(path entry, child)`` pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of every leaf, in flattening order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}/{name}" if prefix else name)


def _rebuild(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by
    ``next(leaves)``."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if like is None:
        return None
    vals = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: v for f, v in zip(dataclasses.fields(like), vals)})
    return type(like)(vals)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """The leaf as a host array, and whether it was bfloat16."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().to(torch.float32).cpu().numpy(), True
        return leaf.detach().cpu().numpy(), False
    return np.asarray(leaf), False


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in _leaves(tree):
        arr, bf16 = _to_numpy(leaf)
        # npz has no bf16 codec: store as f32 with a dtype marker
        flat[(_BF16 + key) if bf16 else key] = arr
    return flat


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    tmp = fname + ".tmp"
    # write to a sibling temp file and rename into place: os.replace is
    # atomic on POSIX, so a crash mid-write leaves only the .tmp orphan
    # (ignored by latest_checkpoint) and never a truncated .npz
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(tree))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)
    return fname


def typed_key_leaves(fname: str) -> List[str]:
    """Paths of the typed JAX PRNG-key leaves of a checkpoint file (those
    of a JAX package checkpoint; none in the port's)."""
    with np.load(fname) as data:
        return [k[len(_KEY):].split(":", 1)[1] for k in data.files
                if k.startswith(_KEY)]


def load_checkpoint(fname: str, like: Any) -> Any:
    """The tree of ``like``'s structure with its leaves read from
    ``fname``: each cast to the ``like`` leaf's dtype and, for a tensor,
    put on its device.  Entries ``like`` does not name (a JAX package
    checkpoint's PRNG key) are not read."""
    with np.load(fname) as data:
        flat = {}
        for k in data.files:
            if k.startswith(_KEY):
                continue
            flat[k[len(_BF16):] if k.startswith(_BF16) else k] = data[k]
    out = []
    for key, leaf in _leaves(like):
        arr = flat[key]
        if torch.is_tensor(leaf):
            out.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
        elif hasattr(leaf, "dtype"):
            out.append(np.asarray(arr, dtype=leaf.dtype))
        else:
            out.append(arr)
    return _rebuild(like, iter(out))


def latest_checkpoint(path: str) -> str | None:
    if not os.path.isdir(path):
        return None
    files = [f for f in os.listdir(path) if re.match(r"ckpt_\d+\.npz$", f)]
    if not files:
        return None
    return os.path.join(path, sorted(files)[-1])
