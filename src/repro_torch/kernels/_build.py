"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: flush-to-zero and approximate ``expf`` would move
results the tests pin.  The libraries go to ``build/repro_torch_kernels/<hash>/``
at the repository root, keyed by a hash of every source under ``csrc/`` (and
the compiler flags), and are built at first use, so a fresh checkout builds
everything the first time a kernel launches.  Nothing here runs when the
module is imported.

Every C entry takes pointers and the CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_F = ctypes.c_float

#: the trailing epilogue arguments of a producer (K3, K4, K6): out format id
#: (-1: f32 out), its encode codec id and its encode tables (meta, thr | sub)
_EPI = [_INT, _INT, _P, _P]

#: C entry -> (library, argtypes); every entry returns a cudaError_t as int.
#: Each takes the format id and the codec id, then the table pointers (null
#: for "bits"): the decode table, or the encode pair (meta, thr | sub); a
#: producer then takes its epilogue arguments; the stream comes last.  K1
#: and K2 take their operands' layout before the format (K1: input, row
#: index, output, rows, columns, input pitch, input rows, scale, output
#: dtype; K2: two sources, two destinations, pairs, elements, run, pitch,
#: source dtype) and ``takum_codec.codec_plan``'s grid, vec, head and tail
#: after the tables (K1 then the width of one row id, 4 or 8, 0 without
#: a row index); ``repro_codec_occupancy`` gives the device's SM count
#: and a codec kernel's blocks per SM.  K3,
#: K4, K3's transposed twin and K6 also take the f32 workspace of their
#: split plan after the output, and the plan's numbers after the shapes;
#: K3, K4 and the transposed twin then the loop (``takum_matmul.LOOPS``)
#: and the tensor-core tiles' block edge.
ENTRIES = {
    "repro_decode": ("takum_codec", [_P, _P, _P, _LL, _LL, _LL, _LL, _P, _INT, _INT, _INT, _P,
                                     _INT, _INT, _LL, _LL, _INT, _P]),
    "repro_encode": ("takum_codec", [_P, _P, _P, _P, _INT, _LL, _LL, _LL, _INT, _INT, _INT, _P,
                                     _P, _INT, _INT, _LL, _LL, _P]),
    "repro_codec_occupancy": ("takum_codec", [_INT, _INT, _INT, _INT, _P, _P]),
    "repro_matmul": ("takum_matmul",
                     [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _P,
                      *_EPI, _P]),
    "repro_dual_matmul": ("takum_dual_matmul",
                          [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _P,
                           *_EPI, _P]),
    "repro_matmul_wt": ("takum_matmul_wt",
                        [_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _P, _P]),
    "repro_decode_attention": (
        "takum_attention",
        [_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _LL, _LL, _LL, _LL, _LL, _LL,
         _INT, _INT, _INT, _INT, _INT, _F, _F, _INT, _INT, _P, *_EPI, _P],
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last build took (0.0 when every library was already built)
last_build_seconds = 0.0
#: wall seconds of each source's nvcc in the last build (name -> s)
last_build_by_source: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build_dir() -> Path:
    """The directory the current sources build into."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, in parallel.  Raises with the compiler's output on failure."""
    global last_build_seconds, last_build_by_source
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(_CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # one thread per nvcc drains its output and clocks its wall time
        done = {}
        waiter = threading.Thread(
            target=lambda p=proc, d=done: d.update(log=p.communicate()[0],
                                                   s=time.perf_counter() - t0))
        waiter.start()
        procs.append((src, lib, tmp, proc, waiter, done))
    errors = []
    last_build_by_source = {}
    for src, lib, tmp, proc, waiter, done in procs:
        waiter.join()
        last_build_by_source[src.name] = done["s"]
        if proc.returncode != 0:
            errors.append(f"{lib.name}: nvcc exited {proc.returncode}\n{done['log']}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    last_build_seconds = time.perf_counter() - t0 if procs else 0.0
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building all kernels at first use."""
    with _lock:
        if name not in _libs:
            out_dir = build_all()
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for entry, (owner, argtypes) in ENTRIES.items():
                if owner == name:
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def entry(fn_name: str):
    """The typed C entry ``fn_name`` from its library."""
    return getattr(library(ENTRIES[fn_name][0]), fn_name)


def check(code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
