"""Train, prefill and serve steps over a process mesh (counterpart of
``repro.dist.step``).

``make_train_step(cfg, mesh)`` gives one step function for every mesh:

* a one-rank mesh: :func:`repro_torch.train.step.make_train_step`, as it is;
* otherwise every rank runs that same step on its rows of the global batch
  (the largest prefix of the data axes that divides it,
  ``sharding.batch_dim_axes``; the other ranks hold copies), and between
  the backward and the update the gradients are reduced over the ranks:
  ``faults.poison_grads`` first, then ``grad_ok`` from the raw flat payload
  (one f32 vector of every gradient, in leaf order), an f32 mean over the
  data axes of the batch, and on a mesh with a "pod" axis of more than one
  rank **one** compressed ring over "pod" in ``cfg.quant.grad_comm``
  (``compressed_pmean``, or ``degraded_pmean`` under ``cfg.quant.guard``).
  The ring's stochastic-rounding key is the step's, decorrelated per pod and
  shared by the replicas of one pod, so every replica sends the same bits.
  The loss, the metrics and ``grad_ok`` are averaged over the batch axes, so
  the guard's skip is the same on every rank, and so are the updates: the
  ranks' params stay bit-identical.
* a "model" axis of more than one rank runs replicated within its group
  (every member computes the same rows), as ``repro``'s pod path runs it;
  tensor-parallel execution over weight shards is not here.

The serving steps give each rank of the data axes its rows of the batch
and run the port's packed path on them (:mod:`repro_torch.serve`).  The
shape and spec builders build the state on the meta device, so they cost
no memory at any width.
"""

from __future__ import annotations

import torch

from repro_torch import serve, tree
from repro_torch.core.formats import wire_format
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState
from repro_torch.quant.qtensor import QTensor
from repro_torch.train import step as single

from . import comm, faults
from . import sharding as shd
from .collectives import compressed_pmean, degraded_pmean

TrainState = single.TrainState


def _has_pod(mesh) -> bool:
    return "pod" in mesh.axis_names and mesh.shape["pod"] > 1


def local_rows(mesh, B: int, axes=None) -> slice:
    """This rank's rows of a global batch of ``B`` rows over ``axes``
    (default: ``batch_dim_axes``), the first axis major."""
    axes = shd.batch_dim_axes(mesh, B) if axes is None else axes
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.index(a)
        n *= mesh.shape[a]
    step = B // n
    return slice(idx * step, (idx + 1) * step)


def _local_batch(mesh, key: str):
    def local(batch):
        rows = local_rows(mesh, batch[key].shape[0])
        return {k: v[rows] for k, v in batch.items()}

    return local


def _pod_key(seed: int, pod: int) -> int:
    """The ring's SR seed of one pod (the step's key folded with the pod)."""
    return faults.mix(seed, 0x77697265, pod)


def make_train_step(cfg, mesh, *, lr=3e-4, aux_weight: float = 0.01):
    """``step(state, batch, rnd=None) -> (state, metrics)`` for ``cfg`` on
    ``mesh`` (see the module docstring); ``batch`` is the global batch, the
    same on every rank."""
    if mesh.size == 1:
        return single.make_train_step(cfg, lr=lr, aux_weight=aux_weight)
    pod = _has_pod(mesh)
    fmt = cfg.quant.grad_comm
    guard = cfg.quant.guard
    wire_sr = cfg.quant.stochastic_rounding and wire_format(fmt).supports_sr
    batch_axes: list = []  # the axes of the step being run

    def sync(grads, metrics, key):
        axes = batch_axes[0]
        flat = torch.cat([g.to(torch.float32).reshape(-1) for g in grads])
        like = [(g.shape, g.dtype) for g in grads]
        grads.clear()  # one copy of the gradients at a time (full width: 6 GB each)
        ok = torch.isfinite(flat).all().to(torch.float32)
        data = [mesh.group(a) for a in axes if a != "pod"]
        flat = comm.mean(flat, data)
        if pod:
            pg = mesh.group("pod")
            sr = _pod_key(key, mesh.index("pod")) if wire_sr else None
            if guard is None:
                flat = compressed_pmean(flat, pg, fmt, sr_key=sr)
            else:
                flat = degraded_pmean(flat, pg, fmt, guard, sr_key=sr)
        out, s = [], 0
        for shape, dtype in like:
            n = shape.numel()
            out.append(flat[s:s + n].view(shape).to(dtype))
            s += n
        names = ("loss", "ce", "aux")
        vals = torch.stack([metrics[k].to(torch.float32) for k in names] + [ok])
        vals = comm.mean(vals, [mesh.group(a) for a in axes])
        return out, dict(zip(names, vals[:3])), vals[3]

    inner = single.make_train_step(cfg, lr=lr, aux_weight=aux_weight,
                                   local_batch=_local_batch(mesh, "tokens"), sync=sync)

    def step(st, batch, rnd=None):
        B = batch["tokens"].shape[0]
        axes = shd.batch_dim_axes(mesh, B)
        if pod and "pod" not in axes:
            raise ValueError(f"global batch {B} must divide by the pod axis "
                             f"({mesh.shape['pod']}) for compressed pod reduction")
        batch_axes[:] = [axes]
        return inner(st, batch, rnd=rnd)

    return step


# ---------------------------------------------------------------------------
# shapes and specs
# ---------------------------------------------------------------------------


def param_shapes(cfg, dtype=torch.float32) -> dict:
    """The raw parameter tree as meta tensors (``T.param_specs``' layout)."""
    from repro_torch.models.mamba2 import MambaParams

    p: dict = {}
    for path, shape, _ in T.param_specs(cfg):
        dt = torch.float32 if path[-1] == "router" else dtype
        T.set_path(p, path, torch.empty(shape, dtype=dt, device="meta"))
    if "ssm" in p["layers"]:
        p["layers"]["ssm"] = MambaParams(**p["layers"]["ssm"])
    return p


def _meta_moment(p: torch.Tensor, fmt: str):
    """A zero moment's structure (``optim.adamw``'s ``_zero``) on meta."""
    wf = wire_format(fmt)
    if wf.name == "f32":
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    if wf.name == "bf16":
        return torch.empty(p.shape, dtype=torch.bfloat16, device="meta")
    if wf.is_block_scaled:
        from repro_torch.quant import blockscale

        payload = torch.empty((*p.shape[:-1], blockscale.payload_len(p.shape[-1])),
                              dtype=torch.uint8, device="meta")
        return QTensor.from_payload(payload, wf.name, p.shape[-1])
    return QTensor(torch.empty(p.shape, dtype=wf.storage, device="meta"), wf.name,
                   torch.empty((), dtype=torch.float32, device="meta"))


def state_shapes(cfg, *, master_dtype=torch.float32) -> TrainState:
    """The full TrainState (params, AdamW step and moments, rng) as meta
    tensors, in the structure ``init_state`` builds."""
    params = param_shapes(cfg, master_dtype)
    fmt = cfg.quant.opt_state
    moments = lambda: tree.map_leaves(lambda a: _meta_moment(a, fmt), params)  # noqa: E731
    opt = AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"), m=moments(),
                     v=moments())
    return TrainState(params, opt, torch.empty((2,), dtype=torch.uint32, device="meta"))


def train_state_specs(cfg, mesh, *, master_dtype=torch.float32) -> list:
    """The specs of ``state_shapes``' leaves, in leaf order: params by the
    rule table, each moment like its parameter, the step and the rng
    replicated.  No surface names "pod": params replicate across pods."""
    shapes = state_shapes(cfg, master_dtype=master_dtype)
    rules = shd.rules_for(cfg, mesh)
    leaves = tree.flatten(shapes)[0]
    return [shd.spec_for(p, leaf, rules, mesh) for p, leaf in zip(tree.paths(shapes), leaves)]


def train_state_specs_nopod(cfg, mesh, *, master_dtype=torch.float32) -> list:
    """:func:`train_state_specs`, which never names "pod" (the name says so
    at the call site)."""
    return train_state_specs(cfg, mesh, master_dtype=master_dtype)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

quantize_params = serve.quantize_params
dequantize_params = serve.dequantize_params


def make_prefill_step(cfg, mesh, cache_len: int | None = None):
    """``step(params, batch) -> (last_logits, cache)`` over this rank's rows
    of the global batch (its data-axes share; ``repro``'s step on a mesh);
    ``params`` is the packed tree of :func:`quantize_params`."""
    inner = serve.make_prefill_step(cfg, cache_len)
    local = _local_batch(mesh, "tokens")
    return lambda params, batch: inner(params, local(batch))


def make_serve_step(cfg, mesh):
    """``step(params, batch, cache) -> (logits, cache)``: one decode step of
    this rank's rows (``batch["token"]`` is the global [B]; the cache is the
    rank's own, from its prefill)."""
    inner = serve.make_serve_step(cfg)
    local = _local_batch(mesh, "token")
    return lambda params, batch, cache: inner(params, local(batch), cache)

