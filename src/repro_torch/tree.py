"""Parameter and state trees in ``jax.tree``'s leaf order (the port's
counterpart of ``jax.tree.flatten`` / ``unflatten`` over ``repro``'s trees).

A tree is nested dicts, NamedTuples, tuples and lists over tensors (or any
other leaf), with :class:`~repro_torch.quant.qtensor.QTensor` nodes.  The
order is jax's: dict keys sorted, NamedTuple and sequence fields in order,
a QTensor as (bits, scale) with a ``None`` scale giving no leaf, ``None``
no leaf at all.  An mx QTensor gives ``repro``'s two leaves, the element
bytes [..., n] and the E8M0 scale bytes [..., ceil(n/32)], and is packed
back into the port's interleaved payload.  With that order the leaf lists
of the two packages match one for one: the AdamW leaves' SR draws and the
checkpoints cross between them.

The walks are module-level functions, not closures over themselves: a
recursive closure is a reference cycle, and one that holds the leaves
keeps a whole model state alive until the garbage collector runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class _Leaf:
    index: int


@dataclasses.dataclass(frozen=True)
class _QNode:
    fmt: str
    n: Any  # mx: logical last-axis length; None for a flat format
    bits: Any
    scale: Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(t, leaves: list):
    from repro_torch.quant import blockscale
    from repro_torch.quant.qtensor import QTensor

    if t is None:
        return None
    if isinstance(t, QTensor):
        if t.block_scaled:
            scales, elems = blockscale.unpack_payload(t.bits)
            return _QNode(t.fmt, t.n, _walk(elems[..., :t.n], leaves), _walk(scales, leaves))
        return _QNode(t.fmt, None, _walk(t.bits, leaves), _walk(t.scale, leaves))
    if isinstance(t, dict):
        return {k: _walk(t[k], leaves) for k in sorted(t)}
    if _is_namedtuple(t):
        return type(t)(*(_walk(x, leaves) for x in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_walk(x, leaves) for x in t)
    leaves.append(t)
    return _Leaf(len(leaves) - 1)


def flatten(tree) -> tuple[list, Any]:
    """(leaves, spec): the leaves in jax's order and what :func:`unflatten`
    rebuilds the tree from."""
    leaves: list = []
    spec = _walk(tree, leaves)
    return leaves, spec


def _build(s, leaves):
    from repro_torch.quant import blockscale
    from repro_torch.quant.qtensor import QTensor

    if s is None:
        return None
    if isinstance(s, _Leaf):
        return leaves[s.index]
    if isinstance(s, _QNode):
        bits, scale = _build(s.bits, leaves), _build(s.scale, leaves)
        if s.n is None:
            return QTensor(bits, s.fmt, scale)
        payload = blockscale.pack_payload(scale, blockscale.pad_block(bits))
        return QTensor.from_payload(payload, s.fmt, s.n)
    if isinstance(s, dict):
        return {k: _build(v, leaves) for k, v in s.items()}
    if _is_namedtuple(s):
        return type(s)(*(_build(x, leaves) for x in s))
    return type(s)(_build(x, leaves) for x in s)


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` in place of the original ones."""
    return _build(spec, leaves)


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, which share its structure)."""
    leaves, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(spec, [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)])


def _paths(t, path: tuple, out: list) -> None:
    from repro_torch.quant.qtensor import QTensor

    if t is None:
        return
    if isinstance(t, QTensor):
        n = 2 if t.block_scaled or t.scale is not None else 1
        out.extend([path] * n)
    elif isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], path + (k,), out)
    elif isinstance(t, (tuple, list)):
        for x in t:
            _paths(x, path, out)
    else:
        out.append(path)


def paths(tree) -> list[tuple]:
    """Each leaf's dict keys from the root, in :func:`flatten`'s order: what
    ``jax.tree_util``'s key paths hold as ``DictKey`` entries (a NamedTuple
    field or a QTensor's bits and scale add no key)."""
    out: list = []
    _paths(tree, (), out)
    return out


def _nodes(t, out: list) -> None:
    from repro_torch.quant.qtensor import QTensor

    if isinstance(t, dict):
        for k in sorted(t):
            _nodes(t[k], out)
    elif isinstance(t, (tuple, list)) and not isinstance(t, QTensor):
        for x in t:
            _nodes(x, out)
    elif t is not None:
        out.append(t)


def nodes(tree) -> list:
    """The leaves of ``tree`` in jax's order, each QTensor one node (what
    ``treedef.flatten_up_to`` gives for a moment tree against its
    parameters' structure)."""
    out: list = []
    _nodes(tree, out)
    return out
