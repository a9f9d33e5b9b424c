"""Production meshes (counterpart of ``repro.launch.mesh``).

A JAX mesh becomes a ``torch.distributed.device_mesh.DeviceMesh`` over
the process group that is already up.  Nothing here starts a group: the
dry run (``launch/dryrun.py``) starts a fake group of 256 or 512 ranks
(``init_process_group("fake", store=FakeStore(), ...)``), which stands
in for the placeholder host devices the reference forces with
``XLA_FLAGS``; a real run starts NCCL or gloo with its own ranks.

``device_type`` follows ``resolve_device``: ``None`` means CUDA (which
raises without a GPU), ``"cpu"`` only when the caller asks for it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device

SINGLE_POD = (16, 16)          # 256 chips
MULTI_POD = (2, 16, 16)        # 2 pods x 256 chips


def _world_size() -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def _mesh(device_type: DeviceLike, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device_type).type
    ranks = torch.arange(math.prod(shape), dtype=torch.int).reshape(shape)
    return DeviceMesh(dev, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: DeviceLike = None):
    """The 16x16 ("data", "model") mesh, or 2x16x16 ("pod", "data",
    "model") with ``multi_pod``, over the first ranks of the group."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {have}; the dry run must "
            f"start the fake process group first: torch.distributed."
            f"init_process_group('fake', store=FakeStore(), rank=0, "
            f"world_size={n})")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model: int = 1, data: int = 1, *,
                   device_type: DeviceLike = None):
    """A small ("data", "model") mesh over the ranks of the group (tests),
    clamped to its size as the reference clamps to its devices."""
    n = max(_world_size(), 1)
    model = min(model, n)
    data = max(1, min(data, n // model))
    return _mesh(device_type, (data, model), ("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
