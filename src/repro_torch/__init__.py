"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core``, ``kernels``, ``quant``,
``models``, ``configs``, ``optim``, ``data``, ``train``, ``launch``) and
imports neither JAX nor ``repro``.  Every
Pallas kernel on the ported path has a hand-written CUDA C++ counterpart
in ``kernels/csrc``; beside each one sits a plain PyTorch version that the
CPU tests run and that ``chip_smoke.py`` holds the kernel against.
"""
