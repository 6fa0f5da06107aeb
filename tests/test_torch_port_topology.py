"""The PyTorch port's ``topology.py`` against the JAX package's: degree
resolution (``-1`` inference, the data axis absorbing the rest, the
errors), ``mesh_degrees`` of a mapping, ``parse_size``,
``hybrid_factorization`` and ``parse_topology`` on the same inputs
(exact: integers and strings); the H100 entry of the chip table; and
what ``detect``, ``build_mesh``, ``initialize_distributed`` and
``resolve_device`` do without and with a process group."""

import pytest
import torch

from torch_automatic_distributed_neural_network_tpu import topology as jtopo
from torch_automatic_distributed_neural_network_tpu_torch import topology
from torch_automatic_distributed_neural_network_tpu_torch.utils import device

REQUESTS = [
    (8, {}), (8, {"tensor": 2}), (8, {"fsdp": -1, "tensor": 2}),
    (8, {"data": -1}), (8, {"pipe": 2, "fsdp": 2}), (4, {"data": 2, "seq": 2}),
    (8, {"tensor": None}), (1, {}), (6, {"tensor": 3}),
    (8, {"fsdp": -1, "tensor": -1}), (8, {"tensor": 3}),
    (8, {"tensor": 0}), (6, {"fsdp": 4, "data": -1}),
]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n,req", REQUESTS, ids=[str(r) for r in REQUESTS])
def test_resolve_degrees_matches_jax(n, req):
    got = _outcome(topology._resolve_degrees, n, req)
    assert got == _outcome(jtopo._resolve_degrees, n, req)
    assert topology.MESH_AXES == jtopo.MESH_AXES


def test_minus_one_infers_and_mesh_degrees_reads_a_mapping():
    full = topology._resolve_degrees(8, {"fsdp": -1, "tensor": 2})
    assert full["fsdp"] == 4 and full["data"] == 1
    assert topology.mesh_degrees(full) == jtopo.mesh_degrees(full) == full
    assert topology.MeshPlan(full).total == 8
    assert topology.MeshPlan(full).degree("tensor") == 2
    assert topology.single_device_mesh() == {ax: 1 for ax in
                                             topology.MESH_AXES}


@pytest.mark.parametrize("degrees,slices", [
    ({"data": 4, "tensor": 2}, 2), ({"pipe": 2, "data": 2, "fsdp": 2}, 4),
    ({"data": 2, "fsdp": 4}, 4), ({"tensor": 8}, 2), ({"data": 8}, 1),
    ({"pipe": 4, "data": 3}, 6)])
def test_hybrid_factorization_matches_jax(degrees, slices):
    assert topology.hybrid_factorization(degrees, slices) == (
        jtopo.hybrid_factorization(degrees, slices))


@pytest.mark.parametrize("text", ["16GiB", "95 GB", "1.5e9", "8K", "3 TiB",
                                  "512", 8589934592, "12 parsecs", "GB"])
def test_parse_size_matches_jax(text):
    assert _outcome(topology.parse_size, text) == _outcome(jtopo.parse_size,
                                                           text)


@pytest.mark.parametrize("spec", ["cpu-8", "cpu-4x2", "cpu-16x4"])
def test_parse_topology_matches_jax_on_the_cpu_fleet(spec):
    got, want = topology.parse_topology(spec), jtopo.parse_topology(spec)
    for field in ("num_devices", "num_hosts", "platform", "device_kind",
                  "num_slices", "devices_per_slice"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.chip.hbm_bytes == want.chip.hbm_bytes
    assert got.chip.flops_per_s == want.chip.flops_per_s


def test_h100_entry_and_the_default_chip():
    """The H100 SXM data sheet; a kind the table lacks takes the JAX
    package's default chip, and no TPU row came over."""
    h100 = topology.chip_spec("NVIDIA H100 80GB HBM3")
    assert h100.flops_per_s == 989.4e12
    assert h100.hbm_bytes == 80 * 10**9
    assert h100.hbm_bytes_per_s == 3.35e12
    assert h100.ici_bytes_per_s == 450e9   # NVLink 4, each way
    assert h100.dcn_bytes_per_s == 50e9    # 400 Gb/s InfiniBand NDR
    default = topology.chip_spec("TPU v5 lite")
    assert default == topology._DEFAULT_CHIP
    assert (default.flops_per_s, default.hbm_bytes) == (
        jtopo._DEFAULT_CHIP.flops_per_s, jtopo._DEFAULT_CHIP.hbm_bytes)
    fleet = topology.parse_topology("h100-8x4", dcn_bytes_per_s=25e9)
    assert (fleet.num_devices, fleet.num_hosts, fleet.platform) == (
        32, 4, "gpu")
    assert fleet.chip.dcn_bytes_per_s == 25e9
    assert fleet.chip.hbm_bytes == h100.hbm_bytes
    with pytest.raises(ValueError, match="unknown device kind"):
        topology.parse_topology("v5p-1024")
    with pytest.raises(ValueError, match="cannot parse"):
        topology.parse_topology("h100")


def test_without_a_process_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    topo = topology.detect()
    assert (topo.num_devices, topo.platform, topo.device_kind) == (
        1, "cpu", "cpu")
    topology.initialize_distributed()  # single process: a no-op
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        topology.build_mesh(data=1)


def test_a_process_group_gives_each_rank_its_card(monkeypatch):
    monkeypatch.setattr(device, "group_up", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert device.resolve_device(None) == torch.device("cuda:3")
    assert device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(device, "group_up", lambda: False)
    assert device.resolve_device(None) == torch.device("cuda")


def test_cli_devices_prints_the_topology(monkeypatch, capsys):
    import json

    from torch_automatic_distributed_neural_network_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert main(["devices", "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "process 0/1"
    assert out[1].startswith("devices: 1 x cpu (cpu)")
    rec = json.loads(out[-1])
    assert (rec["num_devices"], rec["device_kind"], rec["platform"]) == (
        1, "cpu", "cpu")
    assert rec["chip"]["hbm_bytes"] == 8 * 2**30
