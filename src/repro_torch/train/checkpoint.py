"""Fault-tolerant checkpointing: atomic, asynchronous, optionally packed in
a narrow wire format (counterpart of ``repro.train.checkpoint``; the same
layout, meta schema and refusals, so a checkpoint written by either package
restores in the other).

Layout (one directory per step)::

    ckpt_dir/
      step_000000123/
        meta.json            # schema, step, format, per-leaf records
        arrays.npz           # the leaves a0, a1, ... (raw or packed)
      LATEST                 # the last complete step, replaced atomically

* The leaves are the tree's in jax's order (:mod:`repro_torch.tree`), each
  copied to host numpy when ``save`` is called.
* Writes go to ``step_X.tmp``, are fsync'd, then renamed; LATEST is
  written to ``LATEST.tmp``, fsync'd and ``os.replace``'d.
* Each stored array carries a CRC32 of its stored bytes (after packing)
  with its stored dtype and shape (meta schema 2); restore re-hashes and
  raises :class:`CheckpointCorruptionError` on a mismatch.  Schema-1
  checkpoints (no "schema" key, no CRCs) restore without the check.
* Restore validates the schema, the wire format and the leaf count before
  it decodes anything, and raises :class:`CheckpointFormatError` naming
  what it expected and what it found.
* The writer runs on a background thread; ``wait()`` joins it.
* A narrow ``fmt`` packs every floating leaf through the format's float64
  numpy oracle (``WireFormat.encode_np``); integer leaves (packed moment
  bits, the step, the rng) are stored as they are.  numpy has no bfloat16
  here, so a bf16 leaf is stored as its uint16 bits with dtype "bfloat16".
* Restore gives host (CPU) tensors in the structure of its example tree;
  the caller places them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import codecs_np
from repro_torch.core.formats import WIRE_FORMATS, wire_format

#: meta.json schema: 2 adds per-leaf CRC32 + stored dtype/shape
SCHEMA_VERSION = 2


class CheckpointError(RuntimeError):
    """Base class for checkpoint integrity failures."""


class CheckpointCorruptionError(CheckpointError):
    """Stored bytes do not match their recorded CRC32 / are unreadable."""


class CheckpointFormatError(CheckpointError):
    """Schema or wire-format mismatch between checkpoint and this build."""


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _fsync_write(path: str, data: str) -> None:
    with open(path, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


#: torch dtypes numpy takes through a view: (signed torch view, numpy dtype)
_VIEWED = {torch.bfloat16: (torch.int16, np.uint16), torch.uint16: (torch.int16, np.uint16),
           torch.uint32: (torch.int32, np.uint32)}


def _to_host(x) -> np.ndarray:
    """A leaf as a host numpy copy (a bf16 tensor as its uint16 bits): the
    writer thread reads it after the caller has moved on."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    x = x.detach()
    x = x.clone() if x.device.type == "cpu" else x.cpu()
    if x.dtype in _VIEWED:
        signed, np_dtype = _VIEWED[x.dtype]
        return x.view(signed).numpy().view(np_dtype)
    return x.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a, np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype))  # a copy, 0-d kept 0-d


class CheckpointManager:
    def __init__(self, directory: str, *, fmt: str = "f32", keep: int = 3):
        self.dir = directory
        self.fmt = fmt
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``; asynchronous unless ``blocking``."""
        self.wait()  # one write in flight at a time
        leaves, _ = tree_util.flatten(tree)
        host = [_to_host(x) for x in leaves]  # device -> host copy, synchronous
        dtypes = ["bfloat16" if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                  else str(a.dtype) for x, a in zip(leaves, host)]

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            wf = wire_format(self.fmt)
            compress = wf.name != "f32" and wf.nbits < 32
            arrays, meta_leaves = {}, []
            for i, (a, dtype) in enumerate(zip(host, dtypes)):
                if compress and np.issubdtype(a.dtype, np.floating):
                    if wf.is_block_scaled:
                        # whole 32-blocks on a flat view; the logical shape
                        # rides in the meta
                        flat = a.astype(np.float64).reshape(-1)
                        flat = np.concatenate([flat, np.zeros(-len(flat) % 32)])
                        arrays[f"a{i}"] = wf.encode_np(flat).astype(wf.np_storage)
                        meta_leaves.append({"takum": 0, "wire": wf.name, "dtype": dtype,
                                            "shape": list(a.shape)})
                        continue
                    arrays[f"a{i}"] = wf.encode_np(a.astype(np.float64)).astype(wf.np_storage)
                    meta_leaves.append({"takum": wf.nbits if wf.family == "takum" else 0,
                                        "wire": wf.name, "dtype": dtype})
                else:
                    arrays[f"a{i}"] = a
                    meta_leaves.append({"takum": 0, "dtype": dtype})
            for i, info in enumerate(meta_leaves):
                a = arrays[f"a{i}"]
                info.update(crc=_crc(a), stored_dtype=str(a.dtype), stored_shape=list(a.shape))
            npz_path = os.path.join(tmp, "arrays.npz")
            np.savez(npz_path, **arrays)
            with open(npz_path, "rb+") as f:
                os.fsync(f.fileno())
            _fsync_write(os.path.join(tmp, "meta.json"), json.dumps({
                "schema": SCHEMA_VERSION, "step": step, "fmt": self.fmt,
                "num_leaves": len(host), "leaves": meta_leaves,
            }))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_write(os.path.join(self.dir, "LATEST.tmp"), str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"), os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        return [int(d.split("_")[1]) for d in os.listdir(self.dir)
                if d.startswith("step_") and not d.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: int, example_tree: Any) -> Any:
        """Restore into the structure of ``example_tree``: host tensors in
        the leaves' saved dtypes (QTensors rebuilt around their bits and
        scales).  Validates the meta, the wire format and the leaf count
        before decoding, and each leaf's CRC32 where recorded."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.isdir(d):
            raise CheckpointCorruptionError(f"no checkpoint directory at {d}")
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptionError(f"unreadable meta.json in {d}: {e}") from e
        for key in ("step", "fmt", "num_leaves", "leaves"):
            if key not in meta:
                raise CheckpointFormatError(
                    f"meta.json in {d} is missing required key {key!r} "
                    f"(found keys: {sorted(meta)})")
        schema = meta.get("schema", 1)
        if schema > SCHEMA_VERSION:
            raise CheckpointFormatError(
                f"checkpoint {d} uses meta schema {schema}; this build "
                f"supports <= {SCHEMA_VERSION}")
        if meta["fmt"] not in WIRE_FORMATS:
            raise CheckpointFormatError(
                f"checkpoint {d} was saved in wire format {meta['fmt']!r}, "
                f"which this build does not register (registered: {sorted(WIRE_FORMATS)})")
        example, spec = tree_util.flatten(example_tree)
        n_expect = len(example)
        if meta["num_leaves"] != len(meta["leaves"]):
            raise CheckpointFormatError(
                f"meta.json in {d} is inconsistent: num_leaves="
                f"{meta['num_leaves']} but {len(meta['leaves'])} leaf records")
        if meta["num_leaves"] != n_expect:
            raise CheckpointFormatError(
                f"checkpoint {d} holds {meta['num_leaves']} leaves but the "
                f"restore target expects {n_expect} — saved/restored trees "
                "do not match (wrong model config or policy?)")
        try:
            z = np.load(os.path.join(d, "arrays.npz"))
        except Exception as e:  # OSError / zipfile.BadZipFile / ValueError
            raise CheckpointCorruptionError(f"unreadable arrays.npz in {d}: {e}") from e
        leaves = []
        with z:
            for i, info in enumerate(meta["leaves"]):
                leaves.append(_from_host(self._leaf(z, d, i, info), info["dtype"]))
        return tree_util.unflatten(spec, leaves)

    @staticmethod
    def _leaf(z, d: str, i: int, info: dict) -> np.ndarray:
        """Leaf ``i`` read, checked against its CRC32 and decoded."""
        if f"a{i}" not in z.files:
            raise CheckpointCorruptionError(
                f"arrays.npz in {d} is missing leaf a{i} (has {len(z.files)} arrays)")
        try:
            a = z[f"a{i}"]  # npz reads are lazy: zip-level errors surface here
        except Exception as e:
            raise CheckpointCorruptionError(f"leaf a{i} in {d} is unreadable: {e}") from e
        if "crc" in info:
            got = _crc(a)
            if got != info["crc"]:
                raise CheckpointCorruptionError(
                    f"leaf a{i} in {d} failed its integrity check: "
                    f"stored CRC32 {info['crc']:#010x}, recomputed "
                    f"{got:#010x} — bytes corrupted on disk")
        if info.get("wire"):
            if info["wire"] not in WIRE_FORMATS:
                raise CheckpointFormatError(
                    f"leaf a{i} in {d} is packed as {info['wire']!r}, which this build "
                    f"does not register (registered: {sorted(WIRE_FORMATS)})")
            wf = wire_format(info["wire"])
            if wf.is_block_scaled:
                shape = tuple(info["shape"])
                return wf.decode_np(a.astype(np.uint8))[: int(np.prod(shape))].reshape(shape)
            return wf.decode_np(a)
        if info["takum"]:  # pre-registry checkpoints: a bare takum width
            return codecs_np.takum_decode(a, info["takum"])
        return a
