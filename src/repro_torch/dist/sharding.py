"""Sharding rules: logical parameter / batch / cache layouts -> mesh specs
(counterpart of ``repro.dist.sharding``, rule for rule).

A spec is a tuple with one entry per dim: ``None`` (not sharded), an axis
name, or a tuple of axis names (the dim split over their product, the first
axis major), the port's own counterpart of ``PartitionSpec``; ``()`` is
replicated.  Rules are keyed on ``(leaf name, ndim)``, the leaf name being
the innermost dict key on the leaf's path (:func:`repro_torch.tree.paths`),
so raw params, packed QTensor bits under the same key and AdamW moments
that mirror the param tree all find their rule.  Unmatched leaves (norm
gains, SSM params, scalar scales, step counters, the rng) replicate.  A
size-1 axis is never named.

    embed [V,d]           V over model      lm_head [d,V]  V over model
    wq/wk/wv [L,d,Hhd]    heads over model  wo [L,Hhd,d]   contraction over model
    mlp wi/wg [L,d,f]     f over model      mlp wo [L,f,d] f over model
    moe wi/wg/wo [L,E,..] experts over model
    KV cache [L,B,S,Kv,hd]  B over the data axes, S over model

Batch dims shard over the data axes ("pod", "data"), trailing axes dropped
until the batch divides.  :func:`shard_params` maps the specs to each
rank's slice of every leaf (the port's processes hold plain tensors, not
DTensors).  The mesh may be any object with ``axis_names`` and a ``shape``
dict (:class:`repro_torch.launch.mesh.Mesh`, abstract or over ranks).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree


def _model(mesh) -> Optional[str]:
    """The TP axis, or None when absent or of size 1."""
    return "model" if mesh.shape.get("model", 1) > 1 else None


def data_axes(mesh) -> tuple:
    """Axes a global-batch dimension shards over (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names and mesh.shape[a] > 1)


def batch_dim_axes(mesh, batch: Optional[int]) -> tuple:
    """Largest prefix of the data axes that divides ``batch`` evenly."""
    axes = data_axes(mesh)
    if batch is None:
        return axes
    while axes:
        prod = 1
        for a in axes:
            prod *= mesh.shape[a]
        if batch % prod == 0:
            return axes
        axes = axes[:-1]
    return ()


def _entry(axes: tuple):
    """A spec entry over ``axes``: None, one name, or the tuple of names
    (``PartitionSpec`` stores a one-axis tuple as the name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def rules_for(config, mesh) -> dict:
    """(leaf name, ndim) -> spec for ``config`` on ``mesh`` (the base table
    is architecture-independent; ``config`` is kept for ``repro``'s API)."""
    del config
    m = _model(mesh)
    col3 = (None, None, m)
    row3 = (None, m, None)
    moe4 = (None, m, None, None)
    return {
        ("embed", 2): (m, None),
        ("lm_head", 2): (None, m),
        ("media_proj", 2): (None, m),
        ("wq", 3): col3, ("wk", 3): col3, ("wv", 3): col3,
        ("wi", 3): col3, ("wg", 3): col3,
        ("wi_s", 3): col3, ("wg_s", 3): col3,
        ("wo", 3): row3, ("wo_s", 3): row3,
        ("wi", 4): moe4, ("wg", 4): moe4, ("wo", 4): moe4,
        ("router", 3): (),
    }


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop the axes of each dim they do not divide evenly (hymba's
    32001-row embedding stays replicated)."""
    dims = []
    changed = False
    for d, entry in enumerate(spec):
        prod = 1
        for a in _axes(entry):
            prod *= mesh.shape[a]
        if _axes(entry) and shape[d] % prod != 0:
            changed, entry = True, None
        dims.append(entry)
    return tuple(dims) if changed else spec


def spec_for(path, leaf, rules: dict, mesh=None) -> tuple:
    """One leaf's spec: the rule of the innermost name on ``path`` (its dict
    keys from the root) with a rule at the leaf's rank."""
    ndim = len(leaf.shape)
    for name in reversed(tuple(path)):
        if (name, ndim) in rules:
            spec = rules[(name, ndim)]
            return fit_spec(spec, leaf.shape, mesh) if mesh is not None else spec
    return ()


def param_specs(config, params, mesh, *, rules: Optional[dict] = None) -> list:
    """The specs of ``tree.flatten(params)``'s leaves, in that (jax's) order:
    a QTensor's bits take the parameter's rule by name and rank, its scalar
    scale replicates, an mx QTensor's element and scale bytes each take the
    rule at their own shape."""
    rules = rules_for(config, mesh) if rules is None else rules
    leaves = tree.flatten(params)[0]
    return [spec_for(p, leaf, rules, mesh) for p, leaf in zip(tree.paths(params), leaves)]


def batch_specs(config, mesh, *, kind: str, batch: Optional[int] = None) -> dict:
    """Specs of a model input batch; ``kind`` is "train", "prefill" or
    "decode", ``batch`` the global batch size (which data axes divide it)."""
    b = _entry(batch_dim_axes(mesh, batch))
    if kind in ("train", "prefill"):
        specs: dict = {"tokens": (b, None)}
    elif kind == "decode":
        specs = {"token": (b,)}
    else:
        raise ValueError(f"unknown batch kind: {kind}")
    if config.family == "vlm":
        specs["media"] = (b, None, None)
    return specs


def cache_specs(config, cache, mesh):
    """Specs of a ``KVCache`` (returned as a ``KVCache`` of specs): batch
    over the data axes, the cache's sequence over model."""
    m = _model(mesh)
    k_shape = cache.k.shape  # [L, B, S, Kv, feat]
    b = _entry(batch_dim_axes(mesh, k_shape[1]))
    seq = m if k_shape[2] > 0 else None  # the ssm family's K/V is empty
    kv = fit_spec((None, b, seq, None, None), k_shape, mesh)
    conv = (None, b) if getattr(cache.conv, "ndim", 0) == 4 else ()
    ssm = (None, b) if getattr(cache.ssm, "ndim", 0) == 5 else ()
    return type(cache)(k=kv, v=kv, pos=(), conv=conv, ssm=ssm)


def _coord(mesh, axes: tuple) -> tuple[int, int]:
    """(this rank's index, count) over the flattened ``axes`` (first major)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.index(a)
        n *= mesh.shape[a]
    return idx, n


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        i, n = _coord(mesh, axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {axes}")
        step = t.shape[d] // n
        t = t.narrow(d, i * step, step)
    return t


def shard_params(params, mesh, rules: Optional[dict] = None, *, config=None):
    """``params`` with every leaf replaced by this rank's slice of it
    (``repro``'s ``device_put`` onto ``named(mesh, specs)``)."""
    leaves, spec = tree.flatten(params)
    specs = param_specs(config, params, mesh, rules=rules)
    return tree.unflatten(spec, [local_slice(x, s, mesh) for x, s in zip(leaves, specs)])
