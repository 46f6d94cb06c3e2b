"""The port's distribution layer (counterpart of ``repro.dist``).

**The process model.**  Where ``repro`` runs the body of a ``shard_map`` on
every device of a mesh, the port runs SPMD processes, one a rank:

* ``launch/mesh.py`` builds a ``torch.distributed.device_mesh.DeviceMesh``
  over the world's ranks with ``repro``'s axis names, ("data", "model") or
  ("pod", "data", "model"); an axis name resolves to that axis's process
  group (``Mesh.group(name)``), and the collectives here take the group
  where ``repro``'s take an axis name.  ``axis_size`` is the group's size,
  ``lax.axis_index`` the rank's index in it (:mod:`.comm`).
* The backend is chosen by the caller, never switched silently: gloo by
  default, NCCL on request (``backend="nccl"``) for a world where every
  rank has a card of its own.  On the CPU the ranks run gloo.  On one H100
  P ranks are P processes sharing card 0, and since NCCL refuses two ranks
  on one device they run gloo too: a payload is encoded on the card (K2),
  copied into a pinned host buffer, moved by gloo, copied onto the
  receiver's card and decoded there (K1).  That copy is explicit code in
  :mod:`.comm`; a rank-to-rank time on one card is host time, not a wire
  speed.
* Nothing falls back quietly: a rank without CUDA raises unless given
  ``device="cpu"`` (:func:`.spawn.rank_device`), a kernel that fails to
  build or launch raises, every process group has a timeout, and the
  spawners (:mod:`.spawn`) join their ranks with a deadline and fail the
  whole run with each rank's traceback.

Modules: :mod:`.comm` (point-to-point and all-reduce over a group, host
staging), :mod:`.spawn` (process groups and rank processes),
:mod:`.sharding` (the (name, rank)-keyed spec rules), :mod:`.collectives`
(the compressed ring ``compressed_psum`` and its guarded ladder
``degraded_psum``, ``wire_codec``, the traffic model), :mod:`.error_feedback`,
:mod:`.pipeline` (the M + P - 1 tick wavefront over a "pipe" group),
:mod:`.step` (the train step over a mesh, the pod ring included, the spec
builders, the mesh serving steps) and :mod:`.faults` (payload, hop and
gradient faults).  The single-device train step stays
:mod:`repro_torch.train.step`, which :mod:`.step` reuses.

``repro.dist._compat`` (a jax-version shim) and ``repro.dist.actx``
(``with_sharding_constraint`` annotations the models call) have no
counterpart: the port's models annotate nothing, and eager PyTorch has no
trace time to annotate.
"""
