"""Port generate CLI on the CPU: a dataset written by the port, a converted
checkpoint, and a greedy rollout whose video.bin must equal hma_tpu's
generate_tokens in the [prompt | pred | gt] layout."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.data.datasets import RawTokenDataset as JaxRawTokenDataset
from hma_tpu.data.datasets import write_token_dataset as jax_write_token_dataset
from hma_tpu.generate import main as jax_generate_main
from hma_tpu.rollout.maskgit import generate_tokens as jax_generate_tokens
from hma_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch import generate as port_generate
from hma_tpu_torch.data.datasets import RawTokenDataset, write_token_dataset
from hma_tpu_torch.generate import main as generate_main
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from torch_port_helpers import build_pair, tiny_card

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
    root, data, _, _ = env
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate_main(_args(root, data, root / "ckpt", "feat", "--use_feature",
                            "--device", "cpu"))


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
