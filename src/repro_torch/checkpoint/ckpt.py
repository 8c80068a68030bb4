"""Dependency-free checkpointing: a flat npz of a tree's leaves beside a
manifest of its structure.

The port of ``repro.checkpoint.ckpt``, writing the same bundles, so that a
tree saved by either package loads in the other: the leaves are keyed by
their key paths rendered as JAX renders them (``"['health'].finite"``,
``"['pt'][0][1]"``), and the manifest's ``treedef`` is the string
``jax.tree_util.tree_structure`` gives the same tree
(``PyTreeDef({'b': None, 'c': {'x': *}})``).  The port has no
``jax.tree_util``, so it has its own small flattener over ``dict`` (keys
sorted), ``list``, ``tuple``, ``NamedTuple`` and ``None`` (a node with no
leaves); anything else is a leaf.  A tensor leaf goes to numpy on the
host.

Checkpoints are **atomic**: the arrays and the manifest are written into a
single ``.npz`` bundle at a temporary name in the destination directory,
fsynced, and moved into place with ``os.replace`` — a reader (or a resumed
trainer) sees the complete previous checkpoint or the complete new one,
never a torn write.  Killing a trainer at any instant leaves a loadable
checkpoint behind.

Layout: a **retention ring** of per-step bundles
``<path>/checkpoint-{step:08d}.npz``, each holding every leaf plus a
``__manifest__`` JSON entry (the step, the treedef string and the key
list).  ``save_checkpoint`` keeps the newest ``keep_last`` bundles
(default 1) and unlinks older ones only after the new bundle is in place,
so a reader never sees an empty directory.  The supervisor's rollback
(``core.supervisor``) keeps ``keep_last > 1`` and loads an earlier step
with ``load_checkpoint(path, like, step=...)``.

``load_checkpoint`` checks the manifest's treedef and every leaf's shape
against the ``like`` template and raises ``ValueError`` naming the key
that disagrees; it returns the template's structure with numpy leaves cast
to the template's dtypes.  The legacy layouts — the fixed-name
``checkpoint.npz`` bundle and the two-file ``arrays.npz`` +
``manifest.json`` form — are still read.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BUNDLE = "checkpoint.npz"          # legacy fixed-name bundle
_MANIFEST_KEY = "__manifest__"
_STEP_RE = re.compile(r"^checkpoint-(\d{8})\.npz$")


def _step_bundle(step: int) -> str:
    return f"checkpoint-{step:08d}.npz"


def checkpoint_steps(path: str) -> List[int]:
    """Sorted step numbers of the per-step bundles under ``path``."""
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(path: str) -> Optional[str]:
    """Path of the newest checkpoint bundle under ``path`` (or ``None``):
    the ring's newest, else the legacy fixed-name bundle, else the legacy
    ``arrays.npz``."""
    steps = checkpoint_steps(path)
    if steps:
        return os.path.join(path, _step_bundle(steps[-1]))
    legacy = os.path.join(path, _BUNDLE)
    if os.path.exists(legacy):
        return legacy
    if os.path.exists(os.path.join(path, "arrays.npz")):
        return os.path.join(path, "arrays.npz")
    return None


# ---------------------------------------------------------------------------
# the flattener (JAX's key paths and treedef strings)
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _walk(node, path: str, leaves: list) -> str:
    """Append ``(key path, leaf)`` of ``node``'s leaves in JAX's order and
    return its structure as JAX renders it."""
    if node is None:
        return "None"
    if _is_namedtuple(node):
        parts = [_walk(v, f"{path}.{f}", leaves)
                 for f, v in zip(node._fields, node)]
        return (f"CustomNode(namedtuple[{type(node).__name__}], "
                f"[{', '.join(parts)}])")
    if isinstance(node, dict):
        parts = [f"{k!r}: {_walk(node[k], f'{path}[{k!r}]', leaves)}"
                 for k in sorted(node)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(node, (list, tuple)):
        parts = [_walk(v, f"{path}[{i}]", leaves)
                 for i, v in enumerate(node)]
        if isinstance(node, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + (",)" if len(parts) == 1 else ")")
    leaves.append((path, node))
    return "*"


def flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], str]:
    """``([(key path, leaf), ...], treedef string)``: the key paths as
    ``jax.tree_util.keystr`` gives them and the string of
    ``jax.tree_util.tree_structure``, for the same tree."""
    leaves: list = []
    return leaves, f"PyTreeDef({_walk(tree, '', leaves)})"


def unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves`` (dicts come back with their keys sorted, as JAX's
    do)."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(unflatten(v, leaves) for v in template))
    if isinstance(template, dict):
        return {k: unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, tree: Any, step: int = 0,
                    keep_last: Optional[int] = 1) -> None:
    """Atomically write ``tree`` as the step-``step`` bundle under ``path``.

    After the bundle is in place, bundles older than the newest
    ``keep_last`` are unlinked (each unlink is atomic; a concurrent reader
    sees the old ring or the pruned one, never a torn bundle).
    ``keep_last=None`` keeps everything."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"step": int(step), "treedef": flatten_with_path(tree)[1],
                "keys": list(flat.keys())}
    payload = dict(flat)
    payload[_MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".ckpt-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)          # streamed: no copy in memory
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, _step_bundle(int(step))))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    # a legacy fixed-name bundle is superseded once a ring bundle exists;
    # drop it so that latest_checkpoint cannot resolve stale state
    legacy = os.path.join(path, _BUNDLE)
    if os.path.exists(legacy):
        os.unlink(legacy)
    if keep_last is not None:
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        for s in checkpoint_steps(path)[:-keep_last]:
            try:
                os.unlink(os.path.join(path, _step_bundle(s)))
            except FileNotFoundError:
                pass                # a concurrent collection got it first


def discard_after(path: str, step: int) -> None:
    """Unlink every ring bundle newer than ``step`` (the rollback helper:
    the bundles after a rollback target record the diverged trajectory
    and must not win a later ``latest_checkpoint``)."""
    for s in checkpoint_steps(path):
        if s > step:
            try:
                os.unlink(os.path.join(path, _step_bundle(s)))
            except FileNotFoundError:
                pass


def _read_bundle(path: str,
                 step: Optional[int] = None) -> Tuple[Any, Optional[dict]]:
    """``(npz data, manifest dict or None)`` of ``path``: a checkpoint
    directory (its newest ring bundle, or the ``step`` one when given) or a
    bundle file; every layout."""
    if os.path.isfile(path):
        data = np.load(path)
        manifest = None
        if _MANIFEST_KEY in data:
            manifest = json.loads(bytes(data[_MANIFEST_KEY]).decode())
        return data, manifest
    if step is not None:
        bundle = os.path.join(path, _step_bundle(int(step)))
        if not os.path.exists(bundle):
            raise ValueError(
                f"no step-{step} checkpoint under {path!r} "
                f"(have steps {checkpoint_steps(path)})")
        return _read_bundle(bundle)
    newest = latest_checkpoint(path)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint bundle under {path!r}")
    if os.path.basename(newest) == "arrays.npz":
        # legacy two-file layout: arrays.npz + manifest.json
        data = np.load(newest)
        manifest = None
        mpath = os.path.join(path, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        return data, manifest
    return _read_bundle(newest)


def load_checkpoint(path: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore a tree shaped ``like`` from ``path`` (a checkpoint directory
    or a bundle file; ``step=`` picks a ring bundle, default the newest).
    The leaves come back as numpy arrays cast to the template leaves'
    dtypes.  Raises ``ValueError`` naming the key when a stored leaf's
    shape disagrees with the template's, when a key is missing, or when
    the manifest's treedef disagrees with ``like``'s structure."""
    data, manifest = _read_bundle(path, step)
    leaves_with_path, treedef = flatten_with_path(like)
    if manifest is not None and "treedef" in manifest \
            and manifest["treedef"] != treedef:
        raise ValueError(
            f"checkpoint treedef mismatch: stored {manifest['treedef']!r} "
            f"vs template {treedef!r}")
    leaves = []
    for key, leaf in leaves_with_path:
        if key not in data:
            raise ValueError(f"checkpoint at {path!r} is missing key {key!r}")
        arr = data[key]
        if arr.shape != _shape(leaf):
            raise ValueError(
                f"checkpoint shape mismatch for key {key!r}: stored "
                f"{arr.shape} vs template {_shape(leaf)}")
        leaves.append(arr.astype(_dtype(leaf)))
    return unflatten(like, iter(leaves))


def checkpoint_step(path: str, step: Optional[int] = None) -> int:
    """The step recorded in the manifest of ``path``'s newest (or
    ``step``) bundle."""
    _, manifest = _read_bundle(path, step)
    if manifest is None:
        raise ValueError(f"checkpoint at {path!r} has no manifest")
    return manifest["step"]
