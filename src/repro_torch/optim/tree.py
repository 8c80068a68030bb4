"""Parameter trees (nested dicts of tensors, as the LM stack's) for the
optimisers: the port's ``jax.tree.map`` and ``tree_flatten_with_path``.

Leaves are visited in JAX's order (dict keys sorted), and a leaf's path
is the string ``jax.tree_util.keystr`` gives it (``"['embed']"``,
``"['stack']['ssm']['w_in']"``): the checkpoints' flattener renders both
(``checkpoint.ckpt.flatten_with_path``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.checkpoint.ckpt import flatten_with_path, unflatten


def leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(key path, leaf), ...]`` in JAX's order."""
    return flatten_with_path(tree)[0]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the same
    structure); the result has ``tree``'s structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, iter([fn(*xs) for xs in zip(*flat)]))
