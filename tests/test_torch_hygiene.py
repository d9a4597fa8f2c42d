"""The port stands alone: no file of hma_tpu_torch/ or chip_smoke.py imports
JAX, optax, flax or hma_tpu (the collator, sampler and logger are the port's
own copies), importing the port leaves JAX unloaded, and an entry point with
no device on a host without a card raises instead of using the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hma_tpu_torch
from hma_tpu_torch.generate import main as generate_main
from hma_tpu_torch.train_multi import main as train_main

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "hma_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_import_no_jax_or_hma_tpu():
    files = sorted((ROOT / "hma_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"hma_tpu_torch/train/step.py", "hma_tpu_torch/train/trainer.py",
            "hma_tpu_torch/train_multi.py", "hma_tpu_torch/data/collators.py",
            "hma_tpu_torch/data/sampler.py", "hma_tpu_torch/utils/logging.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hma_tpu_torch, hma_tpu_torch.generate, "
            "hma_tpu_torch.convert, hma_tpu_torch.train_multi; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_point_without_device_raises_on_cpu_host(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hma_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_main(["--checkpoint_dir", str(tmp_path), "--val_data_dir",
                       str(tmp_path), "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--genie_config", str(tmp_path / "c.json"),
                    "--output_dir", str(tmp_path / "run")])
    assert hma_tpu_torch.resolve_device("cpu") == torch.device("cpu")
