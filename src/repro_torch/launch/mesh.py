"""Process meshes (counterpart of ``repro.launch.mesh``).

A ``repro`` mesh names the axes of a device grid that ``shard_map`` runs
its body on; here a :class:`Mesh` names the axes of a grid of SPMD
processes, laid out row-major over the world's ranks (the last axis
fastest, as ``jax.make_mesh`` lays out devices).  Built over a process
group it holds a ``torch.distributed.device_mesh.DeviceMesh`` with the same
axis names, and :meth:`Mesh.group` is the axis's ProcessGroup, the handle
the collectives of :mod:`repro_torch.dist` take where ``repro`` takes an
axis name.  A mesh without processes (``Mesh(dims, names)``, the
counterpart of ``jax.sharding.AbstractMesh``, or any single-process mesh)
only carries its shape: the sharding rules read nothing else, and every
axis group of it is ``None`` (a lone process).

The backend is the caller's choice (``backend=``; gloo unless asked
otherwise).  NCCL needs a card per rank; several ranks sharing one card
run gloo.  A mesh whose size differs from the world's raises.
"""

from __future__ import annotations

import math
import os

import torch

#: the mesh axes of ``repro``: "DxM" and "PxDxM"
AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


class Mesh:
    """Named axes over ranks; see the module docstring."""

    def __init__(self, dims, axis_names, device_mesh=None):
        dims = tuple(int(d) for d in dims)
        if len(dims) != len(axis_names) or min(dims, default=1) < 1:
            raise ValueError(f"mesh dims {dims} do not fit axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.dims = dims
        #: axis name -> size, in axis order (``jax.sharding.Mesh.shape``)
        self.shape = dict(zip(self.axis_names, dims))
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def group(self, name: str):
        """The ProcessGroup of axis ``name`` (None on a process-less mesh)."""
        if name not in self.shape:
            raise KeyError(f"mesh has no axis {name!r}: {self.axis_names}")
        if self.device_mesh is None:
            if self.shape[name] > 1:
                raise RuntimeError(f"axis {name!r} of an abstract mesh has no processes")
            return None
        return self.device_mesh.get_group(name)

    def index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (``lax.axis_index``)."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(name)

    def __repr__(self):
        kind = "abstract" if self.device_mesh is None else "ranks"
        return f"Mesh({self.shape}, {kind})"


def make_mesh(dims, axis_names, *, backend: str = "gloo") -> Mesh:
    """A mesh over the world's ranks.  A one-rank mesh in a process without
    a process group is a single process; any other mesh joins (or finds)
    the process group (:func:`repro_torch.dist.spawn.init_ranks`:
    ``torchrun``'s environment, the ``backend`` given) and needs a world of
    exactly its size."""
    import torch.distributed as dist

    from repro_torch.dist.spawn import init_ranks

    mesh = Mesh(dims, axis_names)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != mesh.size:
            raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the world has "
                             f"{world} (start one process a rank, e.g. torchrun "
                             f"--nproc-per-node={mesh.size})")
        if mesh.size == 1:
            return mesh
        init_ranks(backend)
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the world has {world}")
    from torch.distributed.device_mesh import DeviceMesh

    dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(dtype, torch.arange(mesh.size).view(mesh.dims),
                    mesh_dim_names=mesh.axis_names)
    return Mesh(dims, axis_names, dm)


def make_production_mesh(*, multi_pod: bool = False, backend: str = "gloo") -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``.
    Raises on a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, AXES_3D if multi_pod else AXES_2D, backend=backend)


def make_test_mesh(*, multi_pod: bool = False, backend: str = "gloo") -> Mesh:
    """The small CI mesh of 8 ranks: 2x2x2 (pod x data x model) or 2x4."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    return make_mesh(shape, AXES_3D if multi_pod else AXES_2D, backend=backend)


def parse_dims(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """("DxM" | "PxDxM") -> (dims, axis names); raises on anything else."""
    try:
        dims = tuple(int(d) for d in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec must be DxM or PxDxM, got {spec!r}") from None
    if len(dims) == 2:
        return dims, AXES_2D
    if len(dims) == 3:
        return dims, AXES_3D
    raise ValueError(f"mesh spec must be DxM or PxDxM, got {spec!r}")


def parse_mesh(spec: str, *, backend: str = "gloo") -> Mesh:
    """Mesh from a CLI spec: "DxM" -> (data, model), "PxDxM" -> (pod, data,
    model).  "1x1" is the single-process mesh."""
    dims, names = parse_dims(spec)
    return make_mesh(dims, names, backend=backend)


def data_axes(mesh) -> tuple:
    """Axes a global-batch dimension shards over (pod folds into data); see
    :func:`repro_torch.dist.sharding.data_axes`."""
    from repro_torch.dist.sharding import data_axes as _data_axes

    return _data_axes(mesh)
