"""The port stands alone: no file of hma_tpu_torch/ or chip_smoke.py imports
JAX, optax, flax or hma_tpu (the collators, sampler, logger, extern readers
and the native loader's C++ source are the port's own copies), importing the port leaves JAX unloaded, an entry point with no
device on a host without a card raises instead of using the CPU (the
process group too), and the
build compiles every CUDA source under csrc/, K5''s resident entries
among them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hma_tpu_torch
from hma_tpu_torch.generate import main as generate_main
from hma_tpu_torch.parallel.distributed import init_distributed
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.train_tokenizer import main as train_tokenizer_main
from hma_tpu_torch.visualize import main as visualize_main

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
            "hma_tpu_torch/data/sampler.py", "hma_tpu_torch/utils/logging.py",
            "hma_tpu_torch/diffusion/gaussian.py", "hma_tpu_torch/models/diffloss.py",
            "hma_tpu_torch/models/st_mar.py", "hma_tpu_torch/rollout/mar.py",
            "hma_tpu_torch/ops/diffusion_sampler.py", "hma_tpu_torch/ops/temporal_attention.py",
            "hma_tpu_torch/ops/_build.py", "hma_tpu_torch/models/st_transformer.py",
            "hma_tpu_torch/models/attention.py", "hma_tpu_torch/tokenizer/lfq.py",
            "hma_tpu_torch/tokenizer/magvit2.py", "hma_tpu_torch/tokenizer/convert.py",
            "hma_tpu_torch/tokenizer/image_ops.py", "hma_tpu_torch/rollout/decode.py",
            "hma_tpu_torch/data/encode_openx.py", "hma_tpu_torch/sim/simulator.py",
            "hma_tpu_torch/sim/main.py", "hma_tpu_torch/sim/viewer.py",
            "hma_tpu_torch/sim/app.py", "hma_tpu_torch/tokenizer/svd_vae.py",
            "hma_tpu_torch/metrics/fid.py", "hma_tpu_torch/metrics/fvd.py",
            "hma_tpu_torch/evaluate_feature.py", "hma_tpu_torch/metrics/lpips.py",
            "hma_tpu_torch/tokenizer/losses.py", "hma_tpu_torch/tokenizer/discriminator.py",
            "hma_tpu_torch/tokenizer/train_vq.py", "hma_tpu_torch/train_tokenizer.py",
            "hma_tpu_torch/visualize.py", "hma_tpu_torch/data/encode_extern.py",
            "hma_tpu_torch/data/merge_shards.py", "hma_tpu_torch/data/native_loader.py",
            "hma_tpu_torch/data/extern/toyworld.py", "hma_tpu_torch/data/extern/ego4d.py",
            "hma_tpu_torch/data/extern/egoexo4d.py",
            "hma_tpu_torch/data/extern/epic_kitchen.py",
            "hma_tpu_torch/data/extern/robomimic.py", "hma_tpu_torch/train/lowp.py",
            "hma_tpu_torch/models/action_stems.py", "hma_tpu_torch/parallel/mesh.py",
            "hma_tpu_torch/parallel/distributed.py",
            "hma_tpu_torch/parallel/sharded_eval.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hma_tpu_torch, hma_tpu_torch.generate, "
            "hma_tpu_torch.convert, hma_tpu_torch.train_multi, "
            "hma_tpu_torch.rollout.mar, hma_tpu_torch.evaluate, hma_tpu_torch.sim.app, "
            "hma_tpu_torch.sim.main, hma_tpu_torch.sim.viewer, "
            "hma_tpu_torch.tokenizer.svd_vae, hma_tpu_torch.metrics.fid, "
            "hma_tpu_torch.metrics.fvd, hma_tpu_torch.evaluate_feature, "
            "hma_tpu_torch.metrics.lpips, hma_tpu_torch.tokenizer.train_vq, "
            "hma_tpu_torch.train_tokenizer, hma_tpu_torch.visualize, "
            "hma_tpu_torch.data.encode_extern, hma_tpu_torch.data.merge_shards, "
            "hma_tpu_torch.data.native_loader, hma_tpu_torch.data.extern.ego4d, "
            "hma_tpu_torch.data.extern.egoexo4d, hma_tpu_torch.data.extern.epic_kitchen, "
            "hma_tpu_torch.data.extern.robomimic, hma_tpu_torch.parallel.mesh, "
            "hma_tpu_torch.parallel.sharded_eval; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_point_without_device_raises_on_cpu_host(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hma_tpu_torch.resolve_device()
    # the process group starts on the card (NCCL) unless asked for the CPU,
    # and never falls back to one process: TPU metadata discovery raises
    monkeypatch.setenv("HMA_TPU_COORDINATOR", "auto")
    with pytest.raises(NotImplementedError, match="metadata"):
        init_distributed()
    monkeypatch.setenv("HMA_TPU_COORDINATOR", "localhost:1")
    monkeypatch.setenv("HMA_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("HMA_TPU_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    monkeypatch.delenv("HMA_TPU_COORDINATOR")
    monkeypatch.delenv("HMA_TPU_NUM_PROCESSES")
    monkeypatch.delenv("HMA_TPU_PROCESS_ID")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_main(["--checkpoint_dir", str(tmp_path), "--val_data_dir",
                       str(tmp_path), "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--genie_config", str(tmp_path / "c.json"),
                    "--output_dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tokenizer_main(["--train_data_dir", str(tmp_path),
                              "--output_dir", str(tmp_path / "tok")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize_main(["--token_dir", str(tmp_path), "--output_dir", str(tmp_path / "v")])
    assert hma_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_build_lists_every_cuda_source():
    from hma_tpu_torch.ops import _build

    sources = {f.stem for f in (ROOT / "hma_tpu_torch" / "csrc").glob("*.cu")}
    assert set(_build.SOURCES) == sources
    assert {"temporal_resident_fwd", "temporal_resident_bwd"} <= sources
    # a header edit changes every library name that includes it
    assert (ROOT / "hma_tpu_torch" / "csrc" / "temporal_attention.cuh").is_file()
    for name in sources:
        assert _build._target(name).name.startswith(f"lib{name}-")
