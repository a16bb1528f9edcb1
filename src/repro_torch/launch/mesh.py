"""The port's meshes (port of ``repro/launch/mesh.py``): the serving
deployment's ``("kv", "model")`` mesh and the training mesh,
``("data", "model")`` or ``("pod", "data", "model")``.

The port runs one rank a process (SPMD). Every mesh is a
``torch.distributed`` ``DeviceMesh`` over the default process group,
which the caller initializes with the backend of its choice: ``gloo`` on
the CPU and for ranks that share a card, ``nccl`` for one rank a card.

Serving: every rank holds the same weights and runs the same host
scheduler on the same submissions. The ``kv`` dim shards the paged pool's
page axis (each rank stores 1/kv of the pages); the ``model`` dim splits
attention's kv heads into groups.

Training (the reference's FSDP × TP mesh): ``launch.sharding`` places
each parameter and AdamW moment over the dims; the data dims (``pod``
joins ``data``) split each microbatch's rows.

The reference's TPU peak constants and ``make_production_mesh`` belong
to its dry run and are not carried over. :class:`AbstractMesh` stands in
for a mesh where only its shape matters (the placement rules).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

MESH_DIMS = ("kv", "model")


def serving_mesh_shape(world_size: int, num_kv_heads: int) -> tuple:
    """(kv, model) for ``world_size`` ranks, the reference's rule:
    ``model`` is the largest divisor of ``gcd(world_size, num_kv_heads)``
    that still leaves at least two ranks on the page axis (head splits pay
    only once pages are spread), so 1 rank → (1, 1), 2 → (2, 1), 4 with an
    even kv-head count → (2, 2), 4 with one kv head → (4, 1)."""
    g = math.gcd(world_size, num_kv_heads)
    model = 1
    for m in range(g, 0, -1):
        if g % m == 0 and world_size % m == 0 and world_size // m >= 2:
            model = m
            break
    return world_size // model, model


def make_serving_mesh(num_kv_heads: int):
    """The ``("kv", "model")`` ``DeviceMesh`` over every rank of the
    default process group, shaped by :func:`serving_mesh_shape`; rank r
    sits at ``(r // model, r % model)``. The mesh's device type follows the
    group's backend (``"cuda"`` under ``nccl``, else ``"cpu"``); the ranks'
    tensors stay on the devices their callers put them on.

    Raises ``RuntimeError`` when no default process group is initialized:
    the caller starts the ranks and picks the backend."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_serving_mesh needs an initialized default process group: "
            "call torch.distributed.init_process_group(backend, "
            "init_method=..., rank=..., world_size=...) in every rank first "
            "(gloo on the CPU or for ranks that share a card, nccl for one "
            "rank a card)")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    kv, model = serving_mesh_shape(world, num_kv_heads)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(kv, model),
                      mesh_dim_names=MESH_DIMS)


def check_serving_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with dims
    ``("kv", "model")`` (what :func:`make_serving_mesh` builds)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) \
            or tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise TypeError(
            f"mesh= takes a torch.distributed DeviceMesh with dims "
            f"{MESH_DIMS} (launch.mesh.make_serving_mesh), not a "
            f"{type(mesh).__name__}")


def mesh_coords(mesh) -> dict:
    """This rank's ``{"kv": (index, size, group), "model": (...)}``."""
    return {d: (mesh.get_local_rank(d), mesh.size(i), mesh.get_group(d))
            for i, d in enumerate(MESH_DIMS)}


# ---------------------------------------------------------------- training

TRAIN_DIMS = {2: ("data", "model"), 3: ("pod", "data", "model")}


class AbstractMesh:
    """A mesh's dim sizes and names with no ranks behind it (the
    reference's ``jax.sharding.AbstractMesh``): enough for
    :func:`data_axes`, :func:`data_size`, :func:`model_size` and
    ``launch.sharding``'s rules."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"shape {tuple(shape)} and names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)


def make_training_mesh(dims):
    """The training ``DeviceMesh`` of shape ``dims`` over every rank of
    the default process group: dims ``("data", "model")`` for two sizes,
    ``("pod", "data", "model")`` for three (``repro/launch/train.py:
    58-62``). Rank r sits at r's row-major coordinates. The mesh's device
    type follows the group's backend (``"cuda"`` under ``nccl``, else
    ``"cpu"``).

    Raises ``RuntimeError`` when no default process group is initialized,
    and ``ValueError`` when ``dims`` has another length or its product is
    not the world size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_training_mesh needs an initialized default process group: "
            "call torch.distributed.init_process_group(backend, "
            "init_method=..., rank=..., world_size=...) in every rank first "
            "(gloo on the CPU or for ranks that share a card, nccl for one "
            "rank a card)")
    dims = tuple(int(n) for n in dims)
    if len(dims) not in TRAIN_DIMS or min(dims, default=0) < 1:
        raise ValueError(f"a training mesh has 2 or 3 positive dims "
                         f"(data x model, pod x data x model), not {dims}")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"mesh {dims} needs {math.prod(dims)} ranks, the "
                         f"process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(dims),
                      mesh_dim_names=TRAIN_DIMS[len(dims)])


def mesh_sizes(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple:
    """The dims that carry data parallelism: ``("pod", "data")`` when the
    mesh has a ``pod`` dim, else ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_size(mesh) -> int:
    """The product of the data dims' sizes."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def model_size(mesh) -> int:
    return mesh_sizes(mesh)["model"]
