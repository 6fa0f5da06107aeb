"""The PyTorch port stands alone: importing it loads no jax, no port file
(nor ``chip_smoke.py`` or ``time_kernel_build.py``) imports jax or the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = "torch_automatic_distributed_neural_network_tpu_torch"
# the port's name starts with the JAX package's: match that name only
# where it is NOT followed by "_torch"
_FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|optax|orbax|tadnn"
    r"|torch_automatic_distributed_neural_network_tpu(?!_torch))(\.|$)")


def _port_files():
    files = sorted((ROOT / PORT).rglob("*.py"))
    assert len(files) > 10, files
    return files + [ROOT / "chip_smoke.py", ROOT / "time_kernel_build.py"]


def test_forbidden_pattern_tells_the_names_apart():
    assert _FORBIDDEN.match("torch_automatic_distributed_neural_network_tpu")
    assert _FORBIDDEN.match(
        "torch_automatic_distributed_neural_network_tpu.obs.journal")
    assert _FORBIDDEN.match("jax.numpy")
    assert not _FORBIDDEN.match(PORT)
    assert not _FORBIDDEN.match(PORT + ".ops.paged_attention")
    assert not _FORBIDDEN.match("jaxtyping")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _FORBIDDEN.match(name), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


def test_importing_every_port_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
import {PORT} as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tadnn",
                                    "torch_automatic_distributed_neural_network_tpu"))
print("LOADED", len([n for n in sys.modules if n.startswith("{PORT}")]))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_loaded = int(out.stdout.split("LOADED ")[1].split()[0])
    assert n_loaded >= 15, out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from torch_automatic_distributed_neural_network_tpu_torch.inference.serve import (
        ServeEngine,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.models import GPT2
    from torch_automatic_distributed_neural_network_tpu_torch.utils.device import (
        resolve_device,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = GPT2("test", vocab_size=32, max_seq_len=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, n_slots=1, max_len=16, block_size=8)
    eng = ServeEngine(model, n_slots=1, max_len=16, block_size=8,
                      device="cpu")
    assert eng.pool.kv["k"].device.type == "cpu"


def test_cli_serve_defaults_to_cuda(no_cuda):
    from torch_automatic_distributed_neural_network_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["serve", "--smoke"])


def test_kernel_wrapper_launches_or_raises_off_cpu():
    """Only a CPU tensor takes the plain version; any other device goes
    to the kernel or raises — never a quiet fallback."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    q = torch.zeros(1, 2, 8, device="meta")
    pool = torch.zeros(2, 8, 2, 8, device="meta")
    tables = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    ctx = torch.zeros(1, dtype=torch.int32, device="meta")
    before = paged_attention.launches
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q, pool, pool, tables, ctx)
    assert paged_attention.launches == before


def test_flash_wrappers_launch_or_raise_off_cpu():
    """K1-K3 as K4: a tensor off the CPU goes to the kernel or raises,
    and a refused call counts no launch."""
    from torch_automatic_distributed_neural_network_tpu_torch.ops import (
        flash_attention as fa,
    )

    q = torch.zeros(1, 64, 2, 32, device="meta")
    lse = torch.zeros(1, 2, 64, device="meta")
    calls = {fa.flash_forward: (q, q, q),
             fa.flash_dkv: (q, q, q, q, lse, lse),
             fa.flash_dq: (q, q, q, q, lse, lse)}
    for wrapper, args in calls.items():
        before = wrapper.launches
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(*args, causal=True)
        assert wrapper.launches == before
    # the autograd path reaches the same wrappers
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, causal=True)


def test_training_entry_points_default_to_cuda(no_cuda):
    from torch_automatic_distributed_neural_network_tpu_torch import (
        AutoDistribute,
        GPT2,
        next_token_loss,
    )

    model = GPT2("test", vocab_size=32, max_seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoDistribute(model, loss_fn=next_token_loss)
    ad = AutoDistribute(model, loss_fn=next_token_loss, device="cpu")
    assert ad.device == torch.device("cpu")


def test_kernel_build_without_nvcc_is_an_error(monkeypatch, tmp_path):
    from torch_automatic_distributed_neural_network_tpu_torch.ops import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
    # the library name follows the source and the flags
    for name in ("paged_attention", "flash_attention"):
        assert build.library_path(name).name.startswith(f"lib{name}_")


def test_library_path_follows_the_included_headers(monkeypatch, tmp_path):
    """A kernel's library is keyed by its source and by every ``csrc/``
    header the source includes: editing a shared header gives each
    library that includes it a new name, so no stale build is loaded."""
    import shutil

    from torch_automatic_distributed_neural_network_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = ("paged_attention", "flash_attention_sm90", "flash_attention")
    before = {n: build.library_path(n) for n in names}
    for n in ("paged_attention", "flash_attention_sm90"):
        assert (csrc / "sm90_common.cuh") in build._sources(
            csrc / f"{n}.cu", {})
    with open(csrc / "sm90_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["paged_attention"] != before["paged_attention"]
    assert after["flash_attention_sm90"] != before["flash_attention_sm90"]
    assert after["flash_attention"] == before["flash_attention"]


# the trainer stack's modules: each imports with torch and numpy alone
_TRAINER_STACK = (
    "utils.config", "obs.journal", "obs.goodput", "training.metrics",
    "training.resilience", "training.checkpoint", "training.elastic",
    "training.trainer", "data.loader", "examples.train_gpt2", "cli",
    "interop", "core",
)


@pytest.mark.parametrize("module", _TRAINER_STACK)
def test_trainer_stack_module_imports_with_torch_and_numpy_alone(module):
    code = f"""
import sys
import {PORT}.{module}
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "tadnn",
                                    "torch_automatic_distributed_neural_network_tpu"))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_trainer_stack_entry_points_default_to_cuda(no_cuda, tmp_path):
    """``CheckpointManager``, ``TokenFileDataset``, ``MetricsLogger``, the
    ``Trainer`` (through ``AutoDistribute``) and the ``train_gpt2``
    example run on the card unless asked for the CPU, and raise without
    one."""
    from torch_automatic_distributed_neural_network_tpu_torch import (
        GPT2,
        AutoDistribute,
        next_token_loss,
        write_token_file,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.data import (
        TokenFileDataset,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.examples import (
        train_gpt2,
    )
    from torch_automatic_distributed_neural_network_tpu_torch.training import (
        CheckpointManager,
        MetricsLogger,
        Trainer,
    )

    path = str(tmp_path / "c.bin")
    write_token_file(path, list(range(100)))
    for make in (lambda: CheckpointManager(str(tmp_path / "ck")),
                 lambda: TokenFileDataset(path, 8, 2),
                 lambda: MetricsLogger(None),
                 lambda: Trainer(AutoDistribute(
                     GPT2("test", vocab_size=32, max_seq_len=16),
                     loss_fn=next_token_loss)),
                 lambda: train_gpt2.main(["model.size=test"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert CheckpointManager(str(tmp_path / "ck"),
                             device="cpu").device.type == "cpu"
    assert TokenFileDataset(path, 8, 2, device="cpu").device.type == "cpu"
