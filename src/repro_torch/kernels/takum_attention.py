"""K6: one-token GQA decode attention over a packed KV cache (counterpart
of ``repro.kernels.takum_attention.takum_decode_attention``), extended with
what ``repro``'s model computes around it in jnp
(``models/transformer.py:484-498``): a ``length`` bound over a preallocated
cache, a sliding ``window`` and an attention-logit ``softcap``.

An f32 cache (``fmt="f32"``) is read as its raw bits (uint32, 4 bytes an
element: 512 B a row at d = 128, which :func:`split_smem_bytes` sizes).

With an mx cache format, K/V are interleaved payloads [B, Hkv, S,
ceil(d/32)*33] blocked along d; the padded d lanes of the last block are
dropped (d need not be a multiple of 32).

``decode_impl`` picks the K/V decode ("bits" or "lut", see :mod:`.lut`;
None is the format's default).  ``out_fmt`` fuses the output's wire encode
into the kernel's flush (``encode_impl`` picks its codec): the result is the
packed [B, H, d] (an mx out: [B, H, d/32*33], d a multiple of 32), equal bit
for bit to ``ops.encode`` of the unfused output.

On the card S is split across blocks: :func:`attention_plan` cuts the keys
into tile-aligned chunks so that the grid (kv head, batch row, chunk) fills
the H100, each block writes its partial softmax state to an f32 workspace
the wrapper allocates, and a second pass combines the chunks in order.
``takum_decode_attention`` launches ``csrc/takum_attention.cu`` for CUDA
tensors and takes ``decode_attention_plain`` for CPU tensors; ``.launches``
counts the kernel launches per codec, fused launches under their own keys
(``"lut>t8:lut"``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.quant import blockscale
from . import _build, lut
from .common import (IMPL_CODE, TARGET_BLOCKS, count_launch, empty_out, epilogue_args,
                     kernel_format, launch_key, out_format, stream_of, table_ptrs)
from .takum_codec import encode_2d_plain

#: keys per tile of the kernel (``kTileS`` of csrc/takum_attention.cu)
KV_TILE = 32
#: the dynamic shared memory one block may use on the H100 (227 KiB)
SMEM_LIMIT = 227 * 1024


def split_smem_bytes(fmt, impl: str, g: int, d: int) -> int:
    """Shared memory of one ``split_kernel`` block (``split_smem`` of
    csrc/takum_attention.cu): the two-deep ring of a tile's K and V rows,
    each row staged as the 16-byte chunks that cover it at its worst
    alignment, then the f32 regions (q and acc [g, d], K [32, d + 1], V
    [32, d], the tile's probabilities [g, 32], max, denominator and
    rescale [g]), then an 8-bit lut decode table."""
    wf = kernel_format(fmt)
    row = blockscale.payload_len(d) if wf.is_block_scaled else d * wf.nbits // 8
    pitch = 16 * ((row + 30) // 16)
    elem_bits = wf.elem.nbits if wf.is_block_scaled else wf.nbits
    tab = 256 if impl == "lut" and elem_bits == 8 else 0
    floats = 2 * g * d + KV_TILE * (d + 1) + KV_TILE * d + g * KV_TILE + 3 * g
    return 2 * 2 * KV_TILE * pitch + 4 * floats + 4 * tab


class AttentionPlan(NamedTuple):
    """The split of the keys: chunk i covers positions [begin + i * chunk,
    min(begin + (i + 1) * chunk, length)), i < splits."""

    begin: int
    chunk: int
    splits: int

    def workspace_numel(self, B: int, H: int, Hkv: int, d: int) -> int:
        """f32 elements of the partials [B, Hkv, splits, g, d + 2]: each
        query row's unnormalised acc[d], its max and its denominator."""
        return B * Hkv * self.splits * (H // Hkv) * (d + 2)


def attention_plan(B: int, Hkv: int, length: int, window: int = 0) -> AttentionPlan:
    """K6's split of S: the valid keys [lo, length) (lo = length - window
    with a window, else 0) from ``begin``, lo rounded down to a tile, in
    chunks of whole tiles, as long as they can be while the grid
    (Hkv, B, splits) still holds ``TARGET_BLOCKS`` blocks.  The head count
    and head dim change no chunk's length, only each block's work."""
    lo = max(0, length - window) if window > 0 else 0
    begin = lo // KV_TILE * KV_TILE
    keys = length - begin
    need = math.ceil(TARGET_BLOCKS / (B * Hkv))
    chunk = max(KV_TILE, keys // need // KV_TILE * KV_TILE)
    return AttentionPlan(begin, chunk, math.ceil(keys / chunk))


def _valid_keys(S: int, length: int, window: int, device) -> torch.Tensor:
    """[S] bool: key positions a query at position ``length - 1`` attends."""
    kpos = torch.arange(S, device=device)
    valid = kpos < length
    if window > 0:
        valid &= (length - 1 - kpos) < window
    return valid


def decode_attention_plain(q, k_bits, v_bits, fmt, length=None, window=0, softcap=0.0,
                           scale=None, decode_impl=None, out_fmt=None,
                           encode_impl=None) -> torch.Tensor:
    """Plain PyTorch K6: q [B, H, d] f32, k/v bits [B, Hkv, S, d] (an mx
    payload [B, Hkv, S, ceil(d/32)*33]) -> [B, H, d] f32, or with ``out_fmt``
    its plain encode (``encode_impl``)."""
    B, H, d = q.shape
    out_wf, out_impl = out_format(out_fmt, encode_impl, d, "head dim")
    Hkv, S = k_bits.shape[1], k_bits.shape[2]
    g = H // Hkv
    length = S if length is None else length
    scale = d ** -0.5 if scale is None else scale
    dec = lut.decode_fn(fmt, decode_impl)
    k = dec(k_bits)[..., :d]  # an mx payload decodes to padded d: drop the padding
    v = dec(v_bits)[..., :d]
    qg = q.to(torch.float32).reshape(B, Hkv, g, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    valid = _valid_keys(S, length, window, q.device)
    logits = torch.where(valid, logits, torch.full_like(logits, float("-inf")))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v).reshape(B, H, d)
    if out_wf is None:
        return out
    return encode_2d_plain(out.reshape(B * H, d), out_wf, out_impl).reshape(B, H, -1)


def takum_decode_attention(q, k_bits, v_bits, fmt, length=None, window=0, softcap=0.0,
                           scale=None, decode_impl=None, out_fmt=None,
                           encode_impl=None) -> torch.Tensor:
    """K6: q [B, H, d] f32 against packed k/v [B, Hkv, S, d] (an mx payload
    [B, Hkv, S, ceil(d/32)*33]) -> [B, H, d] f32, or with ``out_fmt`` its
    packed encode [B, H, d] (an mx out: [B, H, d/32*33]).

    Keys at positions >= ``length`` (default S) are masked, and with
    ``window > 0`` so are keys ``window`` or more positions before
    ``length - 1``.  k/v may be strided views (the d axis unit-stride), e.g.
    a [B, S, Hkv, d] cache slice permuted to [B, Hkv, S, d].
    """
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    if q.dim() != 3 or k_bits.dim() != 4 or v_bits.shape != k_bits.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k_bits.shape)}, "
                         f"v {tuple(v_bits.shape)}")
    B, H, d = q.shape
    Bk, Hkv, S, dk = k_bits.shape
    dk_want = blockscale.payload_len(d) if wf.is_block_scaled else d
    if (Bk, dk) != (B, dk_want) or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match kv {tuple(k_bits.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_bits.dtype != wf.storage or v_bits.dtype != wf.storage:
        raise TypeError(f"k/v bits must be {wf.storage} for {wf.name}")
    length = S if length is None else int(length)
    if not 1 <= length <= S:
        raise ValueError(f"length must be in [1, {S}], got {length}")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    scale = d ** -0.5 if scale is None else float(scale)
    out_wf, out_impl = out_format(out_fmt, encode_impl, d, "head dim")
    devs = {q.device, k_bits.device, v_bits.device}
    if devs == {torch.device("cpu")}:
        return decode_attention_plain(q, k_bits, v_bits, wf, length, window, softcap, scale,
                                      impl, out_wf, out_impl)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k and v must share one CUDA device, got {devs}")
    if not q.is_contiguous() or k_bits.stride(3) != 1 or v_bits.stride(3) != 1:
        raise ValueError("q must be contiguous and k/v unit-stride along their last axis")
    smem = split_smem_bytes(wf, impl, H // Hkv, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K6 over {wf.name} at g={H // Hkv}, d={d} needs {smem} bytes of "
                         f"shared memory a block, over the {SMEM_LIMIT} the card gives")
    out = empty_out((B, H), d, out_wf, q.device)
    plan = attention_plan(B, Hkv, length, int(window))
    ws = torch.empty(plan.workspace_numel(B, H, Hkv, d), dtype=torch.float32, device=q.device)
    fn = _build.entry("repro_decode_attention")
    _build.check(
        fn(q.data_ptr(), k_bits.data_ptr(), v_bits.data_ptr(), out.data_ptr(), ws.data_ptr(), B,
           H, Hkv, d, *k_bits.stride()[:3], *v_bits.stride()[:3], length, int(window), *plan,
           scale, float(softcap), wf.code, IMPL_CODE[impl],
           *table_ptrs(wf, impl, "decode", q.device), *epilogue_args(out_wf, out_impl, q.device),
           stream_of(q)),
        "takum_decode_attention",
    )
    count_launch(takum_decode_attention, launch_key(impl, out_wf and out_wf.name, out_impl))
    return out


takum_decode_attention.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
