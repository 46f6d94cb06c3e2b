"""Point-to-point and reduction transport over a process group, the port's
counterpart of ``lax.ppermute`` / ``lax.psum`` inside ``shard_map``.

A group is a ``torch.distributed`` ProcessGroup (one axis of a
:class:`~repro_torch.launch.mesh.Mesh`), or ``None`` for a lone process
(an axis of size 1: every op is the identity).  :func:`axis_size` and
:func:`axis_index` are ``repro``'s ``axis_size`` and ``lax.axis_index``.

**Host staging.**  Under gloo a CUDA tensor crosses the wire through the
host, and this module does the copy itself: the payload is copied into a
pinned host buffer, gloo moves it, and the receiver copies it onto its
card.  (gloo's ``send`` / ``recv`` take CPU tensors only: on an H100 a
gloo ``send`` of a CUDA tensor aborted its process with ``gloo::IoException:
writev ... Bad address``.  Its all-reduce would stage CUDA tensors
internally, but one explicit path for every op keeps the copies in
sight.)  On the H100 the ranks are processes sharing
the one card, so every hop between them is such a host round trip: a
rank-to-rank time measured there is host time, not a wire speed.  Under
NCCL (a world where each rank has a card of its own) tensors stay on the
card.  CPU tensors under gloo move as they are.

Staged buffers come from a small per-process cache of pinned buffers,
keyed by slot, dtype and size; big reductions run in chunks of
``STAGE_CHUNK`` elements, so a buffer never holds more than one chunk.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: elements per staged all-reduce chunk (a 256 MiB f32 buffer)
STAGE_CHUNK = 1 << 26

_PINNED: dict = {}


def axis_size(group) -> int:
    """The number of ranks on the axis (1 for a lone process)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index on the axis (0 for a lone process)."""
    return 0 if group is None else dist.get_rank(group)


def staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host buffers (a CUDA tensor
    on a non-NCCL group)."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def pinned(slot: str, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``like``'s size and dtype (flat), reused per
    slot; the cache keeps the latest few."""
    key = (slot, like.dtype, like.numel())
    buf = _PINNED.get(key)
    if buf is None:
        if len(_PINNED) >= 8:
            _PINNED.clear()
        buf = _PINNED[key] = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
    return buf


def to_transport(t: torch.Tensor, group, slot: str = "send") -> torch.Tensor:
    """``t`` as it will cross ``group``: a pinned host copy when staged, else
    ``t`` itself (contiguous)."""
    t = t.contiguous()
    if not staged(t, group):
        return t
    buf = pinned(slot, t).view(t.shape)
    buf.copy_(t)  # device -> pinned host, synchronous for the host
    return buf


def exchange(send: torch.Tensor | None, dst: int | None, recv: torch.Tensor | None,
             src: int | None, group) -> None:
    """Send ``send`` to axis member ``dst`` and receive into ``recv`` from
    ``src`` (either may be None), both in flight together; returns when
    both are done.  Transport tensors only (see :func:`to_transport`),
    moved as their bytes."""
    reqs = []
    if send is not None:
        reqs.append(dist.isend(send.reshape(-1).view(torch.uint8),
                               dist.get_global_rank(group, dst), group=group))
    if recv is not None:
        reqs.append(dist.irecv(recv.view(-1).view(torch.uint8),
                               dist.get_global_rank(group, src), group=group))
    for r in reqs:
        r.wait()


def shift(t: torch.Tensor, group, dst: int | None, src: int | None) -> torch.Tensor | None:
    """Send ``t`` to ``dst`` and receive a tensor of ``t``'s shape and dtype
    from ``src`` onto ``t``'s device (None when ``src`` is None)."""
    send = None if dst is None else to_transport(t, group, "send")
    recv = None
    if src is not None:
        recv = (pinned("recv", t).view(t.shape) if staged(t, group)
                else torch.empty_like(t, memory_format=torch.contiguous_format))
    exchange(send, dst, recv, src, group)
    if recv is None:
        return None
    return recv.to(t.device, copy=True) if recv.device != t.device else recv


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum`` of ``t`` over ``group``, as a new tensor on ``t``'s
    device; staged through the host in chunks of :data:`STAGE_CHUNK`
    elements under gloo.  Every member gets the same bits (the backend
    reduces each element once and shares it)."""
    if group is None or axis_size(group) == 1:
        return t.clone()
    if not staged(t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out
    src = t.contiguous().reshape(-1)
    out = torch.empty_like(src)
    for s in range(0, src.numel(), STAGE_CHUNK):
        part = src[s:s + STAGE_CHUNK]
        host = pinned("reduce", part)
        host.copy_(part)
        dist.all_reduce(host, group=group)
        out[s:s + STAGE_CHUNK].copy_(host)
    return out.view(t.shape)


def mean(t: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``t`` over each group of ``groups`` in turn (``pmean``
    over several axes: sum, then divide by the axis size, axis by axis)."""
    for g in groups:
        n = axis_size(g)
        if n > 1:
            t = all_reduce(t, g).div_(n)
    return t
