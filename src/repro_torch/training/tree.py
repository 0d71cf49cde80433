"""Parameter trees (nested dicts and tuples of tensors) walked as the JAX
package's ``jax.tree_util`` walks them: dict keys in sorted order, tuple
entries by index.  A leaf's name joins its keys and indices with ``/``
(``"groups/0/attn/wq"``), as ``jax.tree_util`` paths print, so the
optimizer sums and a checkpoint names leaves as JAX's do."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def map_named(fn: Callable[[str, Any], Any], tree: Any,
              prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_named(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)
