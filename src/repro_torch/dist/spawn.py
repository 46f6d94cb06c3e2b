"""Start SPMD ranks and their process group, with every wait bounded.

* :func:`init_ranks` joins the process group: its address, world size and
  rank come from the arguments or from ``torchrun``'s environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), and it always
  passes a ``timeout``, so a collective whose peer died raises instead of
  hanging.
* :func:`rank_device` is the rank's device: the CPU when asked for, else a
  card (it raises without CUDA, as :func:`repro_torch.device.resolve_device`
  does).  Under gloo every rank of a host takes card ``local_rank %
  device_count``, i.e. on a one-card machine all of them share card 0;
  under NCCL each rank needs a card of its own.
* :class:`RankPool` spawns ``world`` processes (``torch.multiprocessing``,
  "spawn"), each joined by :func:`init_ranks`, and keeps them alive across
  calls: ``run(fn, *args)`` runs ``fn`` on every rank and returns the
  results in rank order (the CPU tests spawn one pool per module).  It
  joins with a deadline: a rank that raises, dies or outlives it fails the
  whole call with every rank's traceback, and the ranks are killed.
  Results cross back as host copies (tensors become numpy arrays).

``fn`` must be importable by the children (a module-level function; a
script's own functions work, since "spawn" re-imports the script as
``__mp_main__``).
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective waits for its peers before it raises
PG_TIMEOUT_S = 120.0


class RankError(RuntimeError):
    """One or more ranks failed, died or timed out; the message holds each
    rank's traceback."""


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(backend: str = "gloo", *, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None, timeout_s: float = PG_TIMEOUT_S) -> None:
    """``init_process_group`` with an explicit backend and timeout.  Without
    ``init_method`` it reads ``torchrun``'s environment."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
        return
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group address: pass init_method, or run under "
                               f"torchrun (missing {', '.join(missing)})")
        init_method = "env://"
    kw = {} if rank is None else {"rank": rank}
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, else the
    world rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None, backend: str | None = None) -> torch.device:
    """The rank's device: ``device`` when given ('cpu' for the host), else a
    card (raises without CUDA).  It also makes that card current."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run the ranks on "
                           "the host")
    backend = backend or (dist.get_backend() if dist.is_initialized() else "gloo")
    n = torch.cuda.device_count()
    idx = local_rank()
    if backend == "nccl" and idx >= n:
        raise RuntimeError(f"NCCL needs a card per rank: local rank {idx}, {n} card(s)")
    dev = torch.device("cuda", idx % n)
    torch.cuda.set_device(dev)
    return dev


def to_host(x):
    """``x`` with every tensor replaced by a numpy copy (bf16 as its uint16
    bits), for the trip back to the parent."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        if t.dtype in (torch.uint16, torch.uint32):
            return t.view({torch.uint16: torch.int16, torch.uint32: torch.int32}[t.dtype]) \
                .numpy().view({torch.uint16: np.uint16, torch.uint32: np.uint32}[t.dtype]).copy()
        return t.numpy().copy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def _rank_main(rank, world, port, backend, timeout_s, threads, inbox, outbox):
    """A rank's body: join the group, then run tasks until told to stop."""
    try:
        if threads:
            torch.set_num_threads(threads)
        os.environ.setdefault("LOCAL_RANK", str(rank))
        init_ranks(backend, rank=rank, world_size=world,
                   init_method=f"tcp://127.0.0.1:{port}", timeout_s=timeout_s)
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                outbox.put((rank, True, to_host(fn(*args, **kwargs))))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
                break
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass


class RankPool:
    """``world`` rank processes joined in one process group, kept alive
    between calls.  ``run(fn, *args)`` runs ``fn`` on every rank and returns
    the results in rank order, or raises :class:`RankError`; after a failure
    the pool is closed and the next ``run`` starts a fresh one."""

    def __init__(self, world: int, *, backend: str = "gloo", timeout_s: float = PG_TIMEOUT_S,
                 threads: int | None = 1, env: dict | None = None):
        self.world, self.backend, self.timeout_s, self.threads = world, backend, timeout_s, threads
        self.env = dict(env or {})
        self.procs: list = []

    def _start(self):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = free_port()
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)  # the children inherit it at start
        try:
            self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                      args=(r, self.world, port, self.backend, self.timeout_s,
                                            self.threads, self.inboxes[r], self.outbox))
                          for r in range(self.world)]
            for p in self.procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def run(self, fn, *args, timeout_s: float | None = None, **kwargs) -> list:
        if not self.procs:
            self._start()
        for box in self.inboxes:
            box.put((fn, args, kwargs))
        deadline = time.monotonic() + (timeout_s or self.timeout_s + 60.0)
        results: dict = {}
        errors: dict = {}
        while len(results) + len(errors) < self.world and time.monotonic() < deadline:
            try:
                rank, ok, val = self.outbox.get(timeout=1.0)
            except queue.Empty:
                if any(not p.is_alive() for p in self.procs):  # a rank died silently
                    self._drain(results, errors, 2.0)
                    break
                continue
            (results if ok else errors)[rank] = val
            if errors:  # the peers of a failed rank may block until their timeout
                self._drain(results, errors, 5.0)
                break
        if errors or len(results) < self.world:
            self.close()
            raise RankError(self._report(fn, results, errors))
        return [results[r] for r in range(self.world)]

    def _drain(self, results, errors, wait_s):
        """Collect whatever else arrives within ``wait_s``."""
        end = time.monotonic() + wait_s
        while time.monotonic() < end and len(results) + len(errors) < self.world:
            try:
                rank, ok, val = self.outbox.get(timeout=0.1)
            except queue.Empty:
                continue
            (results if ok else errors)[rank] = val

    def _report(self, fn, results, errors) -> str:
        lines = [f"{getattr(fn, '__name__', fn)} failed on {self.world} ranks:"]
        for r in range(self.world):
            if r in errors:
                lines.append(f"--- rank {r} raised:\n{errors[r]}")
            elif r not in results:
                p = self.procs[r] if r < len(self.procs) else None
                code = None if p is None else p.exitcode
                lines.append(f"--- rank {r} gave no result (exit code {code}: "
                             f"{'timed out or blocked' if code is None else 'died'})")
        return "\n".join(lines)

    def close(self):
        for box in getattr(self, "inboxes", []):
            try:
                box.put(None)
            except Exception:
                pass
        end = time.monotonic() + 2.0
        for p in self.procs:
            p.join(timeout=max(end - time.monotonic(), 0.0))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

