"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points default to the card with no fallback to the CPU."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules() -> list[str]:
    out = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "    or m == 'repro' or m.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import TransformerLM, init_kv_cache

    cfg = get_config("qwen2-7b", smoke=True)
    for make in (lambda: resolve_device(), lambda: TransformerLM(cfg),
                 lambda: init_kv_cache(cfg, 1, 8),
                 lambda: get_model(cfg).init_state(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="GPU"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_tensor_never_takes_the_plain_version():
    """A tensor on the card launches the kernel or raises; the wrapper has
    no path from a CUDA tensor to `matmul_ref`."""
    from repro_torch.kernels import tiled_matmul as tm

    src = pathlib.Path(tm.__file__).read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "tiled_matmul")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "matmul_ref"]
    assert len(calls) == 1          # the CPU branch only
