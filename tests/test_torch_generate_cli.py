"""Port generate CLI on the CPU: a dataset written by the port, a converted
checkpoint, and a greedy rollout whose video.bin must equal hma_tpu's
generate_tokens in the [prompt | pred | gt] layout; and the continuous
branch (`--use_feature`) on a latent dataset and an STMAR checkpoint."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.data.datasets import RawFeatureDataset as JaxRawFeatureDataset
from hma_tpu.data.datasets import RawTokenDataset as JaxRawTokenDataset
from hma_tpu.data.datasets import write_token_dataset as jax_write_token_dataset
from hma_tpu.generate import main as jax_generate_main
from hma_tpu.rollout.maskgit import generate_tokens as jax_generate_tokens
from hma_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch import generate as port_generate
from hma_tpu_torch.data.datasets import (
    SVD_SCALE,
    RawFeatureDataset,
    RawTokenDataset,
    write_token_dataset,
)
from hma_tpu_torch.generate import main as generate_main
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.rollout.mar import generate_latents, teacher_forced_latents
from hma_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from torch_port_helpers import build_pair, port_model, tiny_card, tiny_mar_card

PROMPT, B = 2, 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_gen")
    rng = np.random.default_rng(7)
    card = tiny_card()
    n = 30
    video = rng.integers(0, card["image_vocab_size"], size=(n, 4, 4)).astype(np.uint32)
    segs = np.repeat(np.arange(n // 10), 10).astype(np.int32)
    actions = rng.normal(size=(n, card["d_actions"][0])).astype(np.float32)
    data = root / "data"
    write_token_dataset(data, video, segs, actions,
                        {"name": "a", "vocab_size": card["image_vocab_size"]})
    jm, params, _, _, _ = build_pair()
    save_checkpoint(str(root), "ckpt",
                    params_from_jax(params, GenieConfig(**card)), GenieConfig(**card))
    return root, data, jm, params


def _args(root, data, ckpt, out, *extra):
    return ["--checkpoint_dir", str(ckpt), "--val_data_dir", str(data),
            "--output_dir", str(root / out), "--batch_size", str(B),
            "--num_prompt_frames", str(PROMPT), "--maskgit_steps", "2", *extra]


def test_generate_cli_matches_jax_rollout(env, monkeypatch):
    root, data, jm, params = env
    # greedy unmasking, so that the tokens need no jax.random draws to agree
    monkeypatch.setattr(port_generate, "make_generator", functools.partial(
        port_generate.make_generator, unmask_mode="greedy"))
    generate_main(_args(root, data, root / "ckpt", "out", "--device", "cpu"))
    meta = json.loads((root / "out" / "metadata.json").read_text())
    video = np.fromfile(root / "out" / "video.bin", dtype=np.uint32)

    T = jm.config.T
    ds = JaxRawTokenDataset(data, window_size=T, use_actions=True, name="a")
    items = [ds[i] for i in range(B)]
    tokens = np.stack([it["input_ids"] for it in items]).reshape(B, T, -1)
    actions = np.stack([it["action_ids"] for it in items]).astype(np.float32)
    pred = np.asarray(jax_generate_tokens(
        jm, params, jnp.asarray(tokens, jnp.int32), PROMPT, actions,
        jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0), maskgit_steps=2,
        temperature=0.0, unmask_mode="greedy"))
    want = np.concatenate([np.concatenate([tokens[i, :PROMPT], pred[i, PROMPT:],
                                           tokens[i, PROMPT:]]) for i in range(B)])
    np.testing.assert_array_equal(video, want.reshape(-1).astype(np.uint32))
    assert meta["num_images"] == B * (2 * T - PROMPT)

    # the same keys as hma_tpu.generate writes
    jax_ckpt = jax_save_checkpoint(str(root / "jax_run"), "step_1",
                                   {"params": params["params"]},
                                   JaxGenieConfig(**tiny_card()))
    jax_generate_main(_args(root, data, jax_ckpt, "jax_out"))
    jax_meta = json.loads((root / "jax_out" / "metadata.json").read_text())
    assert meta == jax_meta


def test_generate_cli_refuses_feature_family(env):
    """--use_feature on a discrete checkpoint (and a continuous checkpoint
    without it) is refused before any rollout."""
    root, data, _, _ = env
    with pytest.raises(ValueError, match="--use_feature"):
        generate_main(_args(root, data, root / "ckpt", "feat", "--use_feature",
                            "--device", "cpu"))


@pytest.fixture(scope="module")
def feature_env(tmp_path_factory):
    """A latent dataset (float16 (N, C, h, w)) and an STMAR checkpoint of
    the tiny continuous card (the port's weights, every tensor perturbed)."""
    root = tmp_path_factory.mktemp("port_gen_feature")
    rng = np.random.default_rng(11)
    card = tiny_mar_card()
    n = 30
    video = rng.normal(size=(n, 4, 4, 4)).astype(np.float16)
    segs = np.repeat(np.arange(n // 10), 10).astype(np.int32)
    actions = rng.normal(size=(n, card["d_actions"][0])).astype(np.float32)
    data = root / "data"
    write_token_dataset(data, video, segs, actions, {"name": "a", "latent_channels": 4})
    tm = port_model(STMAR, card)  # the CLI is held to the port's rollouts
    save_checkpoint(str(root), "ckpt", tm.state_dict(), DiffusionGenieConfig(**card))
    return root, data, video, segs, actions


@pytest.mark.parametrize("teacher_forced", [False, True])
def test_generate_cli_use_feature(feature_env, teacher_forced):
    root, data, _, _, _ = feature_env
    out = "tf" if teacher_forced else "ar"
    extra = ["--teacher_force_time"] if teacher_forced else []
    args = ["--checkpoint_dir", str(root / "ckpt"), "--val_data_dir", str(data),
            "--output_dir", str(root / out), "--batch_size", str(B),
            "--num_prompt_frames", str(PROMPT), "--use_feature", "--seed", "3",
            "--device", "cpu", *extra]
    generate_main(args)
    with pytest.raises(ValueError, match="--use_feature"):
        generate_main([a for a in args if a != "--use_feature"])

    model, config = load_checkpoint(str(root / "ckpt"), "cpu", torch.float32)
    assert isinstance(model, STMAR) and not model.training
    T = config.T
    meta = json.loads((root / out / "metadata.json").read_text())
    assert meta == {"num_images": B * (2 * T - PROMPT), "h": 4, "w": 4,
                    "latent_channels": 4, "token_dtype": "float16", "name": "a",
                    "num_prompt_frames": PROMPT, "window_size": T,
                    "generation_layout": "prompt,pred,gt"}
    video = np.fromfile(root / out / "video.bin", dtype=np.float16).reshape(
        B, 2 * T - PROMPT, 4, 4, 4)  # per example [prompt | pred | gt] of (C, h, w)

    ds = RawFeatureDataset(data, window_size=T, use_actions=True, domain="a")
    items = [ds[i] for i in range(B)]
    lat = np.stack([it["input_ids"] for it in items]).reshape(B, T, 4, 4, 4)
    acts = torch.from_numpy(np.stack([it["action_ids"] for it in items]))
    gen = torch.Generator().manual_seed(3)
    # the card's maskgit_steps and temperature 1.0 are the defaults
    if teacher_forced:
        frames = teacher_forced_latents(model, torch.from_numpy(lat), acts, 0, gen)
        pred = np.concatenate([lat[:, :1], frames.numpy()], axis=1)
    else:
        pred = generate_latents(model, torch.from_numpy(lat), PROMPT, acts, 0, gen).numpy()
    want = np.concatenate([lat[:, :PROMPT], pred[:, PROMPT:], lat[:, PROMPT:]], axis=1)
    want = (want / SVD_SCALE).transpose(0, 1, 4, 2, 3).astype(np.float16)
    np.testing.assert_array_equal(video, want)
    assert np.isfinite(video.astype(np.float32)).all()


def test_feature_dataset_format_is_byte_identical(feature_env, tmp_path):
    root, data, video, segs, actions = feature_env
    jax_write_token_dataset(tmp_path / "jax", video, segs, actions,
                            {"name": "a", "latent_channels": 4})
    for rel in ["video.bin", "segment_ids.bin", "actions/actions.bin", "metadata.json"]:
        assert (tmp_path / "jax" / rel).read_bytes() == (data / rel).read_bytes(), rel
    ours = RawFeatureDataset(data, window_size=4, use_actions=True, domain="a")
    theirs = JaxRawFeatureDataset(data, window_size=4, use_actions=True, domain="a")
    assert len(ours) == len(theirs) > 0 and ours.name == theirs.name == "a"
    np.testing.assert_array_equal(ours.valid_start_inds, theirs.valid_start_inds)
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) and a["c"] == b["c"] == 4
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    assert a["input_ids"].shape == (4 * 16, 4) and a["input_ids"].dtype == np.float32


def test_dataset_format_is_byte_identical(env, tmp_path):
    root, data, jm, _ = env
    meta = json.loads((data / "metadata.json").read_text())
    video = np.fromfile(data / "video.bin", dtype=np.uint32).reshape(-1, 4, 4)
    segs = np.fromfile(data / "segment_ids.bin", dtype=np.int32)
    acts = np.fromfile(data / "actions" / "actions.bin", dtype=np.float32)
    jax_write_token_dataset(tmp_path / "jax", video, segs, acts.reshape(len(video), -1),
                            {"name": "a", "vocab_size": meta["vocab_size"]})
    for rel in ["video.bin", "segment_ids.bin", "actions/actions.bin", "metadata.json"]:
        assert (tmp_path / "jax" / rel).read_bytes() == (data / rel).read_bytes(), rel
    ours = RawTokenDataset(data, window_size=jm.config.T, use_actions=True, name="a")
    theirs = JaxRawTokenDataset(data, window_size=jm.config.T, use_actions=True, name="a")
    assert len(ours) == len(theirs) > 0
    np.testing.assert_array_equal(ours.valid_start_inds, theirs.valid_start_inds)
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
