"""Device meshes: the production meshes and the small test mesh.

Counterpart of ``repro.launch.mesh``, over
``torch.distributed.device_mesh.DeviceMesh``.  Functions, not module
constants: a mesh is built on the default process group that is already
running (NCCL on the card, gloo in the multi-rank tests, the fake
process group in the dry run), so importing this module touches no
device and starts no group.  The reference's shapes and axis names are
kept, so every sharding spec can be held against the reference's on
the same mesh: (16, 16) over ``("data", "model")`` for one pod of 256
devices, (2, 16, 16) over ``("pod", "data", "model")`` for two.
``device_type`` is the mesh's device kind; ``"cuda"`` without a CUDA
device raises rather than building the mesh on the CPU.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _check_device(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a cuda mesh was asked for but torch.cuda.is_available() is "
            "False; pass device_type='cpu' for a gloo or fake process group")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices."""
    _check_device(device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_small_mesh(data: int = 2, model: int = 2,
                    device_type: str = "cuda") -> DeviceMesh:
    """Test mesh for the multi-rank tests and the one-card run."""
    _check_device(device_type)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}``, the reference's ``mesh.shape``: a
    ``DeviceMesh`` or a duck-typed mesh with ``.shape`` a dict."""
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_name(mesh) -> str:
    sizes = axis_sizes(mesh)
    return "x".join(str(sizes[a]) for a in axis_names(mesh))


def chips(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n
