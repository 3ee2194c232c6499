"""Device meshes over the ranks of a ``torch.distributed`` job.

Counterpart of ``repro/launch/mesh.py``: the same axis names (``data``,
``model``, and ``pod`` across two pods; the pipelined launcher's ``data``,
``stage``), built as `torch.distributed.device_mesh.DeviceMesh` objects.
A rank is one device. The default process group must exist, or the job
must run under ``torchrun`` (`init_device_mesh` then starts it from the
environment); a mesh axis's process group is ``mesh.get_group(axis)``.

Functions, not module constants: importing this module touches no process
group. ``HW`` holds the H100's constants for the dry run and the costs
tooling (``launch/dryrun.py``, ``launch/costs.py``), under the reference's
key names where the meaning is the same; the reference's table describes
a TPU v5e. An H100 job is nodes of 8 cards on NVLink joined by NICs, so
the reference's one ``ici_bw`` has no counterpart: a collective's link
is NVLink where its ranks lie in one node, else the NIC (`link_bw`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


# NVIDIA H100 80GB HBM3, 700 W (SXM5): the NVIDIA H100 Tensor Core GPU
# datasheet (dense peaks, no sparsity) and the DGX H100 system's (8 GPUs a
# node on NVLink 4, one 400 Gb/s ConnectX-7 NIC a GPU).
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700 W (datasheet)",
    "peak_flops_bf16": 989.4e12,    # bf16 tensor cores, dense
    "peak_ops_int8": 1978.9e12,     # int8 tensor cores, dense (popcount too)
    "peak_flops_f32": 66.9e12,      # f32 on the CUDA cores (TF32 off)
    "hbm_bw": 3.35e12,              # B/s, HBM3
    "hbm_bytes": 80e9,              # HBM3 capacity
    "gpus_per_node": 8,             # DGX H100
    "nvlink_bw": 450e9,             # B/s a direction, NVLink 4 (900 both)
    "nic_bw": 50e9,                 # B/s, one 400 Gb/s NIC a GPU
}


def link_bw(intra_node: bool) -> float:
    """The B/s a rank sends at in a collective: NVLink inside a node, the
    NIC across nodes."""
    return HW["nvlink_bw"] if intra_node else HW["nic_bw"]


def mesh_device_type(device=None) -> str:
    """``cuda`` (NCCL) unless the caller asks for the CPU (gloo)."""
    return torch.device("cuda" if device is None else device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) = ('data', 'model') on one pod, (2, 16, 16) = ('pod',
    'data', 'model') on two: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(device), shape,
                            mesh_dim_names=axes)


def make_test_mesh(data: int = 2, model: int = 2, device=None) -> DeviceMesh:
    """A small ('data', 'model') mesh over the first ranks of the world;
    with fewer ranks than data × model it falls back to (1, min(world,
    model)), as the reference does with too few devices."""
    n = dist.get_world_size()
    if n < data * model:
        data, model = 1, min(n, model)
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(mesh_device_type(device), ranks,
                      mesh_dim_names=("data", "model"))


def make_pipeline_mesh(stages: int, device=None) -> DeviceMesh:
    """The pipelined launcher's (world // stages, stages) mesh over
    ('data', 'stage')."""
    n = dist.get_world_size()
    if n % stages:
        raise ValueError(f"{n} devices do not split into {stages} pipeline "
                         f"stages")
    return init_device_mesh(mesh_device_type(device), (n // stages, stages),
                            mesh_dim_names=("data", "stage"))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of a shape-only stand-in with
    ``axis_names`` and a ``shape`` dict (the sharding rules read nothing
    else, so a production layout can be checked without its ranks)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(zip(names, (int(s) for s in mesh.shape)))
