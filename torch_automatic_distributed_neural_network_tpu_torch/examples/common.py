"""What the zoo's examples share: the device line they print."""

import torch

import torch_automatic_distributed_neural_network_tpu_torch as tad
from torch_automatic_distributed_neural_network_tpu_torch.utils.device import resolve_device


def device_of(name: str) -> torch.device:
    """``run.device`` as a device (``cuda`` by default, raising without
    it), after printing the devices line the JAX examples print."""
    device = resolve_device(None if name == "cuda" else name)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"devices: {tad.topology.detect().num_devices} x {kind}")
    return device
