"""Topology discovery and device-mesh construction: the JAX package's
``topology.py`` for GPUs under ``torch.distributed``.

One process drives one device.  The world is the ``torch.distributed``
process group: :func:`detect` reads its size, the CUDA device count
and the card's name; :func:`build_mesh` lays the world out as a
``DeviceMesh`` with the canonical axes:

=========  =======================================================
axis       used by
=========  =======================================================
``data``   data parallelism (batch sharding; DDP)
``fsdp``   ZeRO-3 parameter/optimizer sharding (FSDP2)
``tensor`` Megatron-style tensor parallelism (col/row weight splits)
``seq``    sequence / context parallelism
``pipe``   pipeline parallelism
``expert`` expert parallelism
=========  =======================================================

Axes are ordered slowest-varying first.  ``init_device_mesh`` lays the
ranks out row-major, so the innermost axes (``tensor``, ``seq``) take
consecutive ranks, which share a host and its NVLink, and ``data`` and
``pipe`` may span hosts over InfiniBand: a host plays the part of a TPU
slice (:func:`hybrid_factorization`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Mapping

import torch

from .utils.device import group_up

# Canonical axis ordering: outermost (slowest links OK) -> innermost
# (fastest links required).
MESH_AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")

# Axes that tolerate the network between hosts (one collective per step).
DCN_OK_AXES: tuple[str, ...] = ("pipe", "data")


@dataclasses.dataclass(frozen=True)
class Topology:
    """The devices of this run, or a hypothetical fleet
    (:func:`parse_topology`).  ``num_slices`` counts hosts (the NVLink
    domains); ``chip_override`` carries a :class:`ChipSpec` that differs
    from the table's (a live card's own memory, a network variant)."""

    num_devices: int
    num_hosts: int
    platform: str  # 'gpu' | 'cpu'
    device_kind: str
    num_slices: int = 1
    devices_per_slice: int | None = None
    chip_override: "ChipSpec | None" = None

    @property
    def is_multihost(self) -> bool:
        return self.num_hosts > 1

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1

    @property
    def chip(self) -> "ChipSpec":
        """Per-chip peak numbers for this topology's device kind."""
        if self.chip_override is not None:
            return self.chip_override
        return chip_spec(self.device_kind)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip peak numbers for the planner and the cost models.

    Bandwidths are bytes/s per chip, one direction: ``ici`` is the link
    inside a host (NVLink), ``dcn`` the network between hosts.
    Latencies are per hop."""

    flops_per_s: float  # peak dense bf16 matmul
    hbm_bytes: int  # capacity
    hbm_bytes_per_s: float
    ici_bytes_per_s: float
    dcn_bytes_per_s: float
    ici_latency_s: float = 1e-6
    dcn_latency_s: float = 25e-6


# Keyed by device-kind substring.  'h100' is NVIDIA's H100 SXM data
# sheet: 989.4 TFLOP/s dense bf16, 80 GB HBM3 at 3.35 TB/s, NVLink 4 at
# 450 GB/s each way, and one 400 Gb/s InfiniBand NDR port per GPU
# between hosts.  The 'cpu' entry models the host-platform simulation
# (the JAX package's numbers, so both planners rank alike in tests).
_CHIP_SPECS: dict[str, ChipSpec] = {
    "h100": ChipSpec(989.4e12, 80 * 10**9, 3.35e12, 450e9, 400e9 / 8),
    "cpu": ChipSpec(5e10, 8 * 2**30, 2e10, 1e9, 1e8,
                    ici_latency_s=5e-6, dcn_latency_s=100e-6),
}

# a device kind the table lacks (the JAX package's default chip)
_DEFAULT_CHIP = ChipSpec(1e14, 16 * 2**30, 8e11, 1e11, 6.25e9)


def chip_spec(device_kind: str) -> ChipSpec:
    """:class:`ChipSpec` by device-kind substring (the default chip for
    a kind the table lacks)."""
    dk = device_kind.lower()
    for k, v in _CHIP_SPECS.items():
        if k in dk:
            return v
    return _DEFAULT_CHIP


# Devices per host for hypothetical fleets: an HGX H100 board carries 8;
# the CPU "fleet" is the 8-device host-platform simulation.
_CHIPS_PER_HOST = {"cpu": 8, "h100": 8}
_DEFAULT_CHIPS_PER_HOST = 8


def parse_topology(
    spec: str,
    *,
    dcn_bytes_per_s: float | None = None,
    dcn_latency_s: float | None = None,
) -> Topology:
    """A hypothetical :class:`Topology`: ``"h100-8"`` is 8 cards on one
    host's NVLink; ``"h100-8x4"`` is 4 hosts of 8 joined by InfiniBand.
    The kind must name a :data:`_CHIP_SPECS` entry exactly.
    ``dcn_bytes_per_s`` / ``dcn_latency_s`` override the table's network
    numbers (stored as ``chip_override``)."""
    text = str(spec).strip().lower()
    kind, sep, shape = text.partition("-")
    if not sep or not shape:
        raise ValueError(
            f"cannot parse topology {spec!r} — expected '<kind>-<chips>' "
            f"or '<kind>-<chips_per_host>x<hosts>' (e.g. 'h100-8', "
            f"'h100-8x4')")
    if kind not in _CHIP_SPECS:
        raise ValueError(
            f"unknown device kind {kind!r} in topology {spec!r} — known "
            f"kinds: {sorted(_CHIP_SPECS)}")
    per_slice_s, x, slices_s = shape.partition("x")
    try:
        per_slice = int(per_slice_s)
        num_slices = int(slices_s) if x else 1
    except ValueError:
        raise ValueError(
            f"cannot parse topology {spec!r}: {shape!r} is not "
            f"'<chips>' or '<chips_per_host>x<hosts>'") from None
    if per_slice < 1 or num_slices < 1:
        raise ValueError(
            f"topology {spec!r} needs >= 1 chip per host and >= 1 "
            f"host, got {per_slice}x{num_slices}")
    num_devices = per_slice * num_slices
    chip = _CHIP_SPECS[kind]
    override = None
    if dcn_bytes_per_s is not None or dcn_latency_s is not None:
        override = dataclasses.replace(
            chip,
            dcn_bytes_per_s=(chip.dcn_bytes_per_s if dcn_bytes_per_s is None
                             else float(dcn_bytes_per_s)),
            dcn_latency_s=(chip.dcn_latency_s if dcn_latency_s is None
                           else float(dcn_latency_s)),
        )
    per_host = _CHIPS_PER_HOST.get(kind, _DEFAULT_CHIPS_PER_HOST)
    return Topology(
        num_devices=num_devices,
        num_hosts=max(1, num_devices // per_host),
        platform="cpu" if kind == "cpu" else "gpu",
        device_kind=kind,
        num_slices=num_slices,
        devices_per_slice=per_slice,
        chip_override=override,
    )


_SIZE_UNITS = {
    "": 1, "B": 1,
    "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12,
    "KIB": 2**10, "MIB": 2**20, "GIB": 2**30, "TIB": 2**40,
    # Bare K/M/G/T read as the binary units memory sizes are quoted in.
    "K": 2**10, "M": 2**20, "G": 2**30, "T": 2**40,
}


def parse_size(s: str | int | float) -> int:
    """'16GiB' / '95 GB' / '1.5e9' / 8589934592 -> bytes.  Binary
    suffixes (KiB..TiB, or bare K/M/G/T) are powers of 1024; decimal
    ones (KB..TB) powers of 1000."""
    if isinstance(s, (int, float)):
        return int(s)
    text = str(s).strip()
    i = len(text)
    while i > 0 and not (text[i - 1].isdigit() or text[i - 1] == "."):
        i -= 1
    num, unit = text[:i].strip(), text[i:].strip().upper()
    if not num or unit not in _SIZE_UNITS:
        raise ValueError(
            f"cannot parse size {s!r} — expected e.g. '16GiB', '32GB', "
            "or a plain byte count")
    return int(float(num) * _SIZE_UNITS[unit])


def detect() -> Topology:
    """The devices of this run: the process group's world (one device a
    process), else this process's one device.  A live card's kind is
    its name (``torch.cuda.get_device_name``) and its memory its own
    (``total_memory``, in ``chip_override``); a gloo group, or no CUDA,
    is the CPU platform."""
    dist = torch.distributed
    if group_up():
        world = dist.get_world_size()
        on_gpu = dist.get_backend() == "nccl"
    else:
        world, on_gpu = 1, torch.cuda.is_available()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(1, world // max(1, local))
    if not on_gpu:
        return Topology(num_devices=world, num_hosts=hosts, platform="cpu",
                        device_kind="cpu", num_slices=hosts,
                        devices_per_slice=world // hosts)
    index = torch.cuda.current_device()
    kind = torch.cuda.get_device_name(index)
    chip = dataclasses.replace(
        chip_spec(kind),
        hbm_bytes=torch.cuda.get_device_properties(index).total_memory)
    return Topology(num_devices=world, num_hosts=hosts, platform="gpu",
                    device_kind=kind, num_slices=hosts,
                    devices_per_slice=world // hosts, chip_override=chip)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved per-axis parallelism degrees for a mesh build."""

    axes: Mapping[str, int]

    def degree(self, axis: str) -> int:
        return int(self.axes.get(axis, 1))

    @property
    def total(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1


def _resolve_degrees(
    num_devices: int, requested: Mapping[str, int | None]
) -> dict[str, int]:
    """Fill in unspecified (-1/None) axis degrees so the product covers all
    devices.  At most one axis may be -1; unmentioned axes get 1; if nothing
    is specified, everything goes to ``data``."""
    degrees: dict[str, int] = {}
    infer_axis: str | None = None
    for ax in MESH_AXES:
        v = requested.get(ax)
        if v in (-1, None) and ax in requested:
            if infer_axis is not None:
                raise ValueError(
                    f"At most one mesh axis may be -1 (got {infer_axis!r} "
                    f"and {ax!r})")
            infer_axis = ax
        elif v is not None:
            if v < 1:
                raise ValueError(
                    f"Axis {ax!r} degree must be >=1 or -1, got {v}")
            degrees[ax] = int(v)
    specified = math.prod(degrees.values()) if degrees else 1
    if infer_axis is not None:
        if num_devices % specified:
            raise ValueError(
                f"{num_devices} devices not divisible by specified axes "
                f"product {specified} ({degrees})")
        degrees[infer_axis] = num_devices // specified
    elif not degrees:
        degrees["data"] = num_devices
    else:
        if specified != num_devices:
            # Auto-expand the data axis to absorb remaining devices.
            if num_devices % specified:
                raise ValueError(
                    f"Mesh axes {degrees} (product {specified}) do not "
                    f"divide {num_devices} devices")
            degrees["data"] = degrees.get("data", 1) * (
                num_devices // specified)
    full = {ax: degrees.get(ax, 1) for ax in MESH_AXES}
    assert math.prod(full.values()) == num_devices
    return full


def hybrid_factorization(
    degrees: Mapping[str, int], num_slices: int
) -> tuple[list[int], list[int]] | None:
    """Split every mesh-axis degree into (in-host, cross-host) factors.

    Greedy gcd over the network-tolerant axes in MESH_AXES order: ``pipe``
    absorbs as much of the host count as divides it, then ``data`` takes
    the rest.  NVLink-critical axes (tensor/seq/expert/fsdp) never cross
    hosts.  Returns ``(ici_shape, dcn_shape)`` ordered like MESH_AXES, or
    None when the network-tolerant degrees cannot cover the host count.
    """
    dcn_shape: list[int] = []
    ici_shape: list[int] = []
    remaining = num_slices
    for ax in MESH_AXES:
        d = int(degrees.get(ax, 1))
        if ax in DCN_OK_AXES and remaining > 1:
            g = math.gcd(d, remaining)
            dcn_shape.append(g)
            ici_shape.append(d // g)
            remaining //= g
        else:
            dcn_shape.append(1)
            ici_shape.append(d)
    if remaining != 1:
        return None
    return ici_shape, dcn_shape


def build_mesh(
    *,
    data: int | None = None,
    fsdp: int | None = None,
    tensor: int | None = None,
    seq: int | None = None,
    pipe: int | None = None,
    expert: int | None = None,
    device_type: str | None = None,
):
    """A ``DeviceMesh`` over the process group's world with every axis
    of :data:`MESH_AXES` named (degree 1 where unused).

    Unspecified axes default to 1; ``-1`` for one axis infers its degree
    from the world size; with nothing specified every rank goes to
    ``data``.  ``device_type`` defaults to ``cuda`` under NCCL and
    ``cpu`` under gloo.  Needs an initialized process group
    (:func:`initialize_distributed`, or ``torchrun``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not group_up():
        raise RuntimeError(
            "build_mesh needs a torch.distributed process group: call "
            "topology.initialize_distributed() (under torchrun) first")
    topo = detect()
    requested = {"data": data, "fsdp": fsdp, "tensor": tensor, "seq": seq,
                 "pipe": pipe, "expert": expert}
    requested = {k: v for k, v in requested.items() if v is not None}
    degrees = _resolve_degrees(topo.num_devices, requested)
    if topo.is_multislice and hybrid_factorization(
            degrees, topo.num_slices) is None:
        warnings.warn(
            f"Cannot factor mesh axes {degrees} so that the "
            f"network-tolerant axes {DCN_OK_AXES} cover {topo.num_slices} "
            f"hosts: tensor/fsdp/expert collectives will cross hosts. "
            f"Raise the pipe/data degrees to a multiple of the host count.",
            stacklevel=2)
    if device_type is None:
        device_type = ("cuda" if torch.distributed.get_backend() == "nccl"
                       else "cpu")
    return init_device_mesh(device_type,
                            tuple(degrees[ax] for ax in MESH_AXES),
                            mesh_dim_names=MESH_AXES)


def single_device_mesh() -> dict[str, int]:
    """The one-device mesh, the no-op path: every axis of degree 1, as a
    degrees mapping (one device needs no ``DeviceMesh``)."""
    return {ax: 1 for ax in MESH_AXES}


def mesh_degrees(mesh) -> dict[str, int]:
    """Axis name -> degree of a ``DeviceMesh``, or of a plain degrees
    mapping (the planner's pure functions run on hypothetical meshes)."""
    if isinstance(mesh, Mapping):
        return {ax: int(n) for ax, n in mesh.items()}
    return {ax: int(n) for ax, n in zip(mesh.mesh_dim_names, mesh.shape)}


def initialize_distributed(*, backend: str | None = None,
                           init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, **kwargs) -> None:
    """``init_process_group`` for this process: NCCL on CUDA, gloo on the
    CPU, ``init_method`` passed through (``env://`` under ``torchrun``).
    Under NCCL the process takes the card ``LOCAL_RANK`` names.  A no-op
    when a group is already up, or for a single process launched
    without ``torchrun``'s environment and without an ``init_method``."""
    dist = torch.distributed
    if group_up():
        return
    if init_method is None and world_size is None and (
            "WORLD_SIZE" not in os.environ):
        return  # single-process launch: nothing to initialize
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)
