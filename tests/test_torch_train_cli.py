"""Port training CLI on the CPU: the collator and sampler give arrays
identical to hma_tpu's for the same seed; `python -m hma_tpu_torch.train_multi`
(`main`, `--device cpu`) trains a tiny card on a synthetic two-domain
dataset (the domain-sliced AdamW), checkpoints, and a resumed run ends
bit-for-bit where a straight run does; the final checkpoint rolls out
through `hma_tpu_torch.generate`; the NaN-streak abort fires."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.data.collators import maskgit_collate as jax_collate
from hma_tpu.data.sampler import MultiTaskBatchSampler as JaxSampler
from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.data.collators import maskgit_collate
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.data.sampler import MultiTaskBatchSampler
from hma_tpu_torch.generate import main as generate_main
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.train_multi import parse_args

ROOT = Path(__file__).resolve().parent.parent
DOMAINS = ("language_table", "bridge")  # strides 1 and 2 from the freq table


@pytest.mark.parametrize("seed", range(6))
def test_collator_matches_jax(seed):
    card = dict(num_layers=1, num_heads=1, d_model=8, T=4, S=16,
                image_vocab_size=2**18, num_factored_vocabs=2, num_prompt_frames=2,
                non_mlm_ratio=0.5)
    rng = np.random.default_rng(100 + seed)
    items = [{"input_ids": rng.integers(0, 2**18, 64), "h": 4, "w": 4, "domain": "a",
              "action_ids": rng.normal(size=(4, 3)).astype(np.float32)}
             for _ in range(3)]
    got = maskgit_collate(items, GenieConfig(**card), np.random.default_rng(seed))
    want = jax_collate(items, JaxGenieConfig(**card), np.random.default_rng(seed))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_sampler_matches_jax():
    sizes = [37, 5, 120]
    for epoch in (0, 3):
        ours = MultiTaskBatchSampler(sizes, batch_size=8, temperature=3.0, seed=7)
        theirs = JaxSampler(sizes, batch_size=8, temperature=3.0, seed=7)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs)
        np.testing.assert_array_equal(ours.generate_tasks_distribution(),
                                      theirs.generate_tasks_distribution())
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a, b)


def test_read_domains_matches_yaml(tmp_path):
    files = sorted((ROOT / "experiments" / "datasplit").glob("*.yaml"))
    assert files
    (tmp_path / "plain.yaml").write_text(yaml.safe_dump({"domains": "a, b,c"}))
    for f in [*files, tmp_path / "plain.yaml"]:
        want = [d.strip() for d in yaml.safe_load(f.read_text())["domains"].split(",")]
        assert trainer.read_domains(str(f)) == [d for d in want if d], f.name


@pytest.fixture(scope="module")
def synth_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    data = root / "data"
    rng = np.random.default_rng(0)
    vocab, (h, w) = 2**18, (4, 4)
    for domain in DOMAINS:
        for split, n in (("train", 80), ("val", 40)):
            write_token_dataset(
                data / f"{domain}_magvit_max1000000_{split}",
                rng.integers(0, vocab, (n, h, w)).astype(np.uint32),
                np.repeat(np.arange(n // 10), 10), rng.normal(size=(n, 2)).astype(np.float32),
                {"name": domain, "vocab_size": vocab, "s": h * w})
    cfg = GenieConfig(num_layers=2, num_heads=2, d_model=32, T=4, S=16,
                      image_vocab_size=vocab, num_factored_vocabs=2,
                      action_token_size=8, action_network="concat+modulate",
                      num_prompt_frames=2, use_actions=True)
    cfg.save_pretrained(str(root / "config.json"))
    (root / "split.yaml").write_text(yaml.safe_dump({"domains": ",".join(DOMAINS)}))
    return root, data


def _train_argv(root, data, out, *extra):
    return ["--genie_config", str(root / "config.json"), "--output_dir", str(out),
            "--train_split", str(root / "split.yaml"), "--data_root", str(data),
            "--window_size", "4", "--per_device_train_batch_size", "4",
            "--per_device_eval_batch_size", "2", "--learning_rate", "3e-3",
            "--eval_every_n_steps", "6", "--max_eval_steps", "2",
            "--checkpointing_steps", "6", "--num_warmup_steps", "2",
            "--log_every", "2", "--vis_every_n_steps", "6", "--seed", "3",
            "--device", "cpu", *extra]


def test_train_overfit_checkpoint_resume_and_generate(synth_env):
    root, data = synth_env
    out = root / "run"
    train_main(_train_argv(root, data, out, "--max_train_steps", "12",
                           "--overfit_first_batch"))
    assert (out / "step_6").is_dir() and (out / "step_12").is_dir()
    assert (out / "final_checkpt" / "config.json").is_file()
    lines = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert lines[0]["_config"]["num_datasets"] == 2
    losses = [l["train/loss"] for l in lines if "train/loss" in l]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # overfit-first-batch converges
    assert all(l["train/skipped"] == 0.0 for l in lines if "train/loss" in l)
    assert [l["_step"] for l in lines if "val/loss" in l] == [6, 12]
    vis = [l for l in lines if "vis/rollout_token_match" in l]
    assert len(vis) == 1 and 0.0 <= vis[0]["vis/rollout_token_match"] <= 1.0
    state = torch.load(out / "step_12" / "train_state.pt", weights_only=True)
    assert state["step"] == 12 and sum(state["opt_state"]["domain_count"]) == 12

    # the final checkpoint rolls out through the generate CLI
    gen = root / "gen"
    generate_main(["--checkpoint_dir", str(out), "--val_data_dir",
                   str(data / f"{DOMAINS[0]}_magvit_max1000000_val"),
                   "--output_dir", str(gen), "--batch_size", "2",
                   "--num_prompt_frames", "2", "--device", "cpu"])
    meta = json.loads((gen / "metadata.json").read_text())
    video = np.fromfile(gen / "video.bin", dtype=np.uint32)
    assert meta["num_images"] == 2 * (2 * 4 - 2) and video.size == meta["num_images"] * 16
    assert video.max() < meta["vocab_size"]


def test_resume_equals_straight_run(synth_env):
    """Resuming from a straight run's own step_6 in a fresh directory, with
    the same LR horizon, ends at step 12 in the same params and optimizer
    state bit for bit: the sampler position is replayed and each step's
    collate RNG depends on (seed, step) only."""
    root, data = synth_env
    straight, resumed = root / "straight", root / "resumed"
    train_main(_train_argv(root, data, straight, "--max_train_steps", "12"))
    train_main(_train_argv(root, data, resumed, "--max_train_steps", "12",
                           "--resume_from_checkpoint", str(straight / "step_6")))
    a, b = (torch.load(d / "step_12" / "model.pt", weights_only=True)
            for d in (straight, resumed))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = (torch.load(d / "step_12" / "train_state.pt", weights_only=True)
              for d in (straight, resumed))
    assert sa["step"] == sb["step"] == 12
    assert sa["opt_state"]["domain_count"] == sb["opt_state"]["domain_count"]
    assert sa["opt_state"]["count"] == sb["opt_state"]["count"] == 12
    for k in sa["opt_state"]["m"]:
        assert torch.equal(sa["opt_state"]["m"][k], sb["opt_state"]["m"][k]), k
        assert torch.equal(sa["opt_state"]["v"][k], sb["opt_state"]["v"][k]), k
    # the resumed run wrote only step_12 and final_checkpt
    assert sorted(p.name for p in resumed.iterdir() if p.is_dir()) == \
        ["final_checkpt", "step_12"]


def test_nan_streak_aborts_and_unported_flags_raise(synth_env, monkeypatch):
    root, data = synth_env

    def always_skipped(model, tx, microbatch=0):
        def step(batch):
            return {"loss": torch.tensor(float("nan")), "acc": torch.tensor(0.0),
                    "grad_norm": torch.tensor(float("nan")), "skipped": torch.tensor(1.0)}
        return step

    def skipped_once(model, tx, microbatch=0):
        calls = []

        def step(batch):
            calls.append(1)
            skipped = float(len(calls) == 2)
            return {"loss": torch.tensor(1.0), "acc": torch.tensor(0.0),
                    "grad_norm": torch.tensor(1.0), "skipped": torch.tensor(skipped)}
        return step

    # max_nan_skip_steps is a TrainArgs field, as in hma_tpu: no flag
    args = parse_args(_train_argv(root, data, root / "nan", "--max_train_steps", "12"))
    args.max_nan_skip_steps = 1
    monkeypatch.setattr(trainer, "make_train_step", skipped_once)
    trainer.run_training(args)  # one sampled transient does not abort
    monkeypatch.setattr(trainer, "make_train_step", always_skipped)
    with pytest.raises(RuntimeError, match="NaN guard"):
        trainer.run_training(args)
    for flag in (["--mu_transfer"], ["--adam_moment_dtype", "bfloat16"],
                 ["--use_native_loader"], ["--model_type", "continuous"],
                 ["--fsdp", "2"], ["--sliced_grads", "on"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_main(_train_argv(root, data, root / "no", *flag))
