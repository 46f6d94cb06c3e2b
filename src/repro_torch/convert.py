"""``repro`` parameters -> the port's (numpy in, torch out).

``params_from_numpy(tree, cfg)`` takes ``repro``'s parameter tree with every
leaf as numpy: a plain array, or a packed leaf given as
``{"bits", "fmt", "scale"}`` (a ``QTensor``'s fields).  ``repro``'s
``MambaParams`` (``layers.ssm`` of the ssm and hybrid archs) may come as
that NamedTuple or as a dict of its eight fields; either becomes the port's
:class:`~repro_torch.models.mamba2.MambaParams`.  Bits and scale are
kept unchanged: a flat format's scale is its f32 power of two; an mx
format's bits are the element bytes [..., n] and its scale the uint8 E8M0
bytes [..., ceil(n/32)], which are interleaved into the port's payload.
The caller converts from ``repro``; this module imports neither JAX nor
``repro``.

``train_state_from_numpy(tree, cfg)`` takes ``repro``'s ``TrainState``
the same way (params, AdamW step and moments, the uint32[2] rng), so both
packages can start training from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import wire_format
from repro_torch.device import resolve_device
from repro_torch.models.mamba2 import MambaParams
from repro_torch.quant import blockscale
from repro_torch.quant.qtensor import QTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")  # a copy; 0-d stays 0-d
    return torch.from_numpy(a).to(device)


def _leaf(x, device):
    if isinstance(x, dict) and set(x) == {"bits", "fmt", "scale"}:
        wf = wire_format(x["fmt"])
        bits = _tensor(x["bits"], device)
        if wf.name not in ("bf16", "f32") and bits.dtype != wf.storage:
            raise TypeError(f"{wf.name} bits must be {wf.storage}, got {bits.dtype}")
        if wf.is_block_scaled:
            scales = _tensor(x["scale"], device)
            n = bits.shape[-1]
            if scales.dtype != torch.uint8 or scales.shape != (*bits.shape[:-1], -(-n // 32)):
                raise TypeError(f"{wf.name} scale must be uint8 [..., ceil(n/32)], got "
                                f"{scales.dtype} {tuple(scales.shape)}")
            payload = blockscale.pack_payload(scales, blockscale.pad_block(bits))
            return QTensor.from_payload(payload, wf.name, n)
        scale = None if x["scale"] is None else _tensor(x["scale"], device).to(torch.float32)
        return QTensor(bits, wf.name, scale)
    if getattr(x, "_fields", None) == MambaParams._fields:
        return MambaParams(*(_leaf(v, device) for v in x))
    if isinstance(x, dict) and set(x) == set(MambaParams._fields):
        return MambaParams(**{k: _leaf(x[k], device) for k in MambaParams._fields})
    if isinstance(x, dict):
        return {k: _leaf(v, device) for k, v in x.items()}
    return _tensor(x, device)


def params_from_numpy(tree: dict, cfg, *, device=None) -> dict:
    """Port-side parameter tree on ``device`` (the card unless 'cpu')."""
    dev = resolve_device(device)
    out = _leaf(tree, dev)
    emb = out["embed"]
    if tuple(emb.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed shape {tuple(emb.shape)} does not match {cfg.name}")
    _check_tree(out, cfg)
    return out


#: a moe layer's leaves, and those of its shared expert
MOE_LEAVES = ("router", "wi", "wg", "wo")
SHARED_LEAVES = ("wi_s", "wg_s", "wo_s")


#: per family, the layer blocks a tree must hold (of ``attn``, ``mlp``,
#: ``moe``, ``ssm``); the others it must not
FAMILY_BLOCKS = {"dense": ("attn", "mlp"), "audio": ("attn", "mlp"), "moe": ("attn", "moe"),
                 "ssm": ("ssm",), "hybrid": ("attn", "mlp", "ssm"), "vlm": ("attn", "mlp")}

#: a vlm's cross-layer leaves (``cross_layers``)
CROSS_LEAVES = ("wq", "wk", "wv", "wo", "ln", "gate")


def _check_tree(params: dict, cfg) -> None:
    """Refuse a tree whose head, norms or layer blocks do not match
    ``cfg``: an ``lm_head`` under a tied config or none under an untied
    one; and where the tree has ``layers``: gemma2's post-norm gains missing under ``alt_local_global`` or
    present without it; a layer block of ``attn``, ``mlp``, ``moe`` and
    ``ssm`` missing where the family has it or present where it has not
    (:data:`FAMILY_BLOCKS`), and ``ln2`` likewise (every family but "ssm"); an ``ssm`` that is
    not a :class:`MambaParams` or whose ``in_proj`` is not ``[L, d, 2 d_in +
    2 N + nh]``; a moe tree lacking a leaf of :data:`MOE_LEAVES`, whose
    experts are not ``num_experts``, or whose shared-expert leaves
    (:data:`SHARED_LEAVES`) are missing under ``num_shared_experts`` or
    present without it; ``cross_layers`` or ``media_proj`` present in a
    tree of another family than "vlm", or, in a vlm tree, missing, lacking
    a leaf of :data:`CROSS_LEAVES`, or not of the config's shapes
    (``Lc = num_layers / cross_attn_every`` cross layers, ``media_proj``
    [media_d, d])."""
    if cfg.tie_embeddings == ("lm_head" in params):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'lm_head' in params else 'lacks'} an lm_head")
    if "layers" not in params:  # a partial tree (the embedding alone): nothing more to hold
        return
    _check_cross(params, cfg)
    layers = params["layers"]
    want = FAMILY_BLOCKS[cfg.family]
    for k in ("attn", "mlp", "moe", "ssm", "ln2"):
        wanted = k in want or (k == "ln2" and cfg.family != "ssm")
        if wanted != (k in layers):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} but the tree "
                             f"{'has' if k in layers else 'lacks'} layers.{k}")
    if "ssm" in layers:
        pr = layers["ssm"]
        d_in = cfg.ssm_expand * cfg.d_model if cfg.family == "ssm" else cfg.d_model
        N = cfg.ssm_state
        width = 2 * d_in + 2 * N + d_in // cfg.ssm_head_dim
        if not isinstance(pr, MambaParams) or tuple(pr.in_proj.shape) != (
                cfg.num_layers, cfg.d_model, width):
            raise ValueError(f"{cfg.name}: layers.ssm is not a MambaParams with in_proj "
                             f"[{cfg.num_layers}, {cfg.d_model}, {width}]")
    for k in ("ln1_post", "ln2_post"):
        if cfg.alt_local_global != (k in layers):
            raise ValueError(f"{cfg.name}: alt_local_global={cfg.alt_local_global} but the "
                             f"tree {'has' if k in layers else 'lacks'} layers.{k}")
    if cfg.family == "moe":
        mp = layers["moe"]
        for k in MOE_LEAVES + SHARED_LEAVES:
            if (k in MOE_LEAVES or cfg.num_shared_experts > 0) != (k in mp):
                raise ValueError(f"{cfg.name}: num_shared_experts={cfg.num_shared_experts} but "
                                 f"the tree {'has' if k in mp else 'lacks'} layers.moe.{k}")
        if mp["router"].shape[-1] != cfg.num_experts or mp["wi"].shape[1] != cfg.num_experts:
            raise ValueError(f"{cfg.name}: the tree's experts do not number "
                             f"num_experts={cfg.num_experts}")


def _check_cross(params: dict, cfg) -> None:
    """The vlm leaves of :func:`_check_tree`."""
    vlm = cfg.family == "vlm"
    for k in ("cross_layers", "media_proj"):
        if vlm != (k in params):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} but the tree "
                             f"{'has' if k in params else 'lacks'} {k}")
    if not vlm:
        return
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Lc = cfg.num_layers // cfg.cross_attn_every
    want = {"wq": (Lc, d, H * hd), "wk": (Lc, d, Kv * hd), "wv": (Lc, d, Kv * hd),
            "wo": (Lc, H * hd, d), "ln": (Lc, d), "gate": (Lc,)}
    cross = params["cross_layers"]
    for k, shape in want.items():
        if k not in cross or tuple(cross[k].shape) != shape:
            raise ValueError(f"{cfg.name}: cross_layers.{k} is not {list(shape)}")
    if tuple(params["media_proj"].shape) != (cfg.media_d, d):
        raise ValueError(f"{cfg.name}: media_proj is not [{cfg.media_d}, {d}]")


def _field(t, name: str):
    return t[name] if isinstance(t, dict) else getattr(t, name)


def train_state_from_numpy(tree, cfg, *, device=None):
    """``repro``'s ``TrainState`` as numpy (``params``, ``opt`` with
    ``step``/``m``/``v``, ``rng``; NamedTuples or dicts; quantised moments as
    ``{"bits", "fmt", "scale"}``) -> the port's ``TrainState``: params and
    moments on ``device`` (the card unless 'cpu'), the rng on the host."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.step import TrainState

    dev = resolve_device(device)
    opt = _field(tree, "opt")
    rng = np.asarray(_field(tree, "rng"))
    if rng.dtype != np.uint32 or rng.shape != (2,):
        raise TypeError(f"rng must be uint32[2], got {rng.dtype} {rng.shape}")
    return TrainState(
        params=params_from_numpy(_field(tree, "params"), cfg, device=dev),
        opt=AdamWState(step=_tensor(np.asarray(_field(opt, "step"), np.int32), dev),
                       m=_leaf(_field(opt, "m"), dev), v=_leaf(_field(opt, "v"), dev)),
        rng=torch.from_numpy(rng.copy()))
