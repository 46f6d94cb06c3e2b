#!/usr/bin/env python3
"""The host cost of a telemetry capture on llama3-8b's decode step, on one GPU.

    python3 tools/capture_profile.py

Builds the kernels, times ``torch.cuda.Event`` creation and record,
``torch.cuda.current_stream`` and ``torch.cuda.current_device`` (2000 calls
each), then serves llama3-8b at full width and depth under
``takum_guarded`` (``chip_smoke.obs_model``: B = 4, a 256-token prompt) and
times 4 decode steps uncaptured, under ``telemetry.capture()``, uncaptured
and captured again (ms/token, host clock, synchronised); then prints
cProfile's top 25 functions by own time over 4 uncaptured and 4 captured
steps.  Prints the card's name and power limit first.
"""
import contextlib
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import configs, serve
    from repro_torch.core import telemetry
    from repro_torch.kernels import _build
    from repro_torch.quant.policy import POLICIES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    s = torch.cuda.current_stream()
    for label, fn in (("Event()", lambda: torch.cuda.Event(enable_timing=True)),
                      ("Event().record", lambda: torch.cuda.Event(enable_timing=True).record(s)),
                      ("current_stream", lambda: torch.cuda.current_stream(0)),
                      ("current_device", torch.cuda.current_device)):
        keep = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            keep.append(fn())
        print(f"{label}: {(time.perf_counter() - t0) / 2000 * 1e6:.2f} us each", flush=True)
        del keep
    cfg = configs.get("llama3_8b").with_(quant=POLICIES["takum_guarded"])
    qp, prompt = cs.obs_model(torch, dev, cfg)
    prefill = serve.make_prefill_step(cfg, cache_len=cs.OBS_S0 + 40)
    step = serve.make_serve_step(cfg)
    state = list(prefill(qp, {"tokens": prompt}))  # [logits, cache]

    def steps(n):
        for _ in range(n):
            state[:] = step(qp, {"token": torch.argmax(state[0], -1)}, state[1])
        torch.cuda.synchronize()

    def scope(label):
        return telemetry.capture() if label == "captured" else contextlib.nullcontext()

    steps(2)
    for label in ("uncaptured", "captured", "uncaptured", "captured"):
        with scope(label):
            t0 = time.perf_counter()
            steps(4)
            ms = (time.perf_counter() - t0) / 4 * 1e3
        print(f"{label}: {ms:.2f} ms/token", flush=True)
    for label in ("uncaptured", "captured"):
        pr = cProfile.Profile()
        with scope(label):
            pr.enable()
            steps(4)
            pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(25)
        print(f"==== {label} (4 steps) by tottime\n" + out.getvalue()[:6000], flush=True)


if __name__ == "__main__":
    main()
