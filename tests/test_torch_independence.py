"""The port stands alone: no JAX, nothing of the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import PE, Cluster, Fabric, local_triple, resolve_device
from repro_torch.core.bitcode import deserialize_and_jit, deserialize_eager, load_program
from repro_torch.core.pe import CodeCacheLayer
from repro_torch.core.xrdma import make_gather_return

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch.core, repro_torch.runtime, repro_torch.kernels; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cluster_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_explicit_cpu_runs_on_the_host():
    cl = Cluster(2, device="cpu")
    assert all(pe.device == torch.device("cpu") for pe in cl.pes())
    assert [pe.triple for pe in cl.pes()] == ["cpu-bf2", "cpu-bf2", "cpu-host"]
    assert local_triple("cpu") == "cpu-host"


@pytest.mark.parametrize("entry", ["pe", "code_cache", "load_program",
                                   "deserialize_and_jit", "deserialize_eager"])
def test_entry_points_without_a_card_raise(monkeypatch, entry):
    blob = make_gather_return(2, 2, 2).fat.slices["cpu-host"]
    calls = {
        "pe": lambda: PE("server0", Fabric()),
        "code_cache": lambda: CodeCacheLayer("server0", "cpu-host", None, None),
        "load_program": lambda: load_program(blob),
        "deserialize_and_jit": lambda: deserialize_and_jit(blob),
        "deserialize_eager": lambda: deserialize_eager(blob),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_triple_must_run_on_its_device():
    """A CPU slice on the card would run its plain body there and never the
    card's kernels; a cuda slice runs on the host only when the caller
    names the CPU, through the kernels' plain versions."""
    with pytest.raises(ValueError, match="cannot run on device cuda"):
        Cluster(2, device="cuda", server_triple="cpu-bf2", client_triple="cpu-host")
    with pytest.raises(ValueError, match="cannot run on device cuda"):
        PE("server0", Fabric(), triple="cpu-host", device="cuda")
    with pytest.raises(ValueError, match="cannot run on device meta"):
        PE("server0", Fabric(), triple="cuda-sm90", device="meta")
    cl = Cluster(2, device="cpu", server_triple="cuda-sm90")
    assert [pe.triple for pe in cl.pes()] == ["cuda-sm90", "cuda-sm90", "cpu-host"]
    assert cl.restart_server(1).triple == "cuda-sm90"
    assert PE("solo", Fabric(), device="cpu").triple == "cpu-host"
