"""The port's encode pipeline against hma_tpu's, on the CPU in fp32: the shard
helpers over a grid, `resize_image` on the data's real shapes (the float
resize to 1e-3 before rounding, then uint8 within one level on at most 0.1 %
of values), `encode_episodes` raw and through the small MagVit2 codec (byte-
equal shard files, equal metadata), `make_svd_encoder` on a tiny VAE (float16
latents within one float16 ulp), `merge_shards` over raw, token and latent
shards with a missing and an empty shard (byte-equal outputs), both `main`s
(byte-equal directories) and the entry points without a card."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.data import encode_extern as jax_encode_extern
from hma_tpu.data import encode_openx as jax_encode_openx
from hma_tpu.data import merge_shards as jax_merge_shards
from hma_tpu.data.extern import toyworld as jax_toyworld
from hma_tpu.tokenizer import image_ops as jax_image_ops
from hma_tpu.tokenizer import svd_vae as jax_svd_vae
from hma_tpu.tokenizer.magvit2 import VQModel as JaxVQModel
from hma_tpu_torch.data import encode_extern, encode_openx, merge_shards
from hma_tpu_torch.data.extern import toyworld
from hma_tpu_torch.tokenizer import image_ops
from hma_tpu_torch.tokenizer.convert import params_from_flax
from hma_tpu_torch.tokenizer.magvit2 import VQConfig
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE
from test_tokenizer import small_cfg

RESIZE_FLOAT_TOL = 1e-3  # levels, before rounding
RESIZE_SHARE = 1e-3  # of uint8 values that may differ, by one level
SVD_LATENT_TOL = 1e-5  # of max|z|, float16 latents near zero


def test_shard_helpers_match_jax():
    for total in (0, 1, 7, 59, 480, 1000, 4001):
        for n in (1, 3, 7, 60):
            for i in range(n):
                assert (encode_openx.get_shard_inds(total, n, i)
                        == jax_encode_openx.get_shard_inds(total, n, i))
    for total in range(0, 6000, 37):
        assert encode_openx.val_split_size(total) == jax_encode_openx.val_split_size(total)
    img = np.zeros((2, 2, 3), np.uint8)
    for keys in (["image"], ["wrist_image", "rgb"], ["hand_image", "agentview_image"],
                 ["image_1", "front_rgb", "depth"]):
        obs = {k: img + j for j, k in enumerate(keys)}
        np.testing.assert_array_equal(encode_openx.select_image(obs),
                                      jax_encode_openx.select_image(obs))
    with pytest.raises(KeyError, match="no known image key"):
        encode_openx.select_image({"depth": img})


@pytest.mark.parametrize("shape,target,keep_res", [
    ((480, 640, 3), 256, False), ((256, 320, 3), 256, False),
    ((200, 200, 3), 256, False), ((256, 256, 3), 64, False),
    ((1100, 1200, 3), 256, True)])
def test_resize_matches_jax(shape, target, keep_res):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    crop = image_ops.center_crop_to_square(img)
    out = min(crop.shape[0] if keep_res else target, 1024)
    want_f = np.asarray(jax.image.resize(jnp.asarray(crop, jnp.float32), (out, out, 3),
                                         method="bilinear"))
    got_f = image_ops.resize_bilinear(crop, out)
    assert np.abs(got_f - want_f).max() <= RESIZE_FLOAT_TOL
    got = image_ops.resize_image(img, target, keep_res=keep_res)
    want = jax_image_ops.resize_image(img, target, keep_res=keep_res)
    assert got.dtype == np.uint8 and got.shape == want.shape == (out, out, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_SHARE


def _episodes(gen, image_size=16, episode_len=10):
    """Two toyworld episodes, then one whose first step has no known image
    key (the writer skips it), then one more."""
    eps = list(gen(0, 1, image_size=image_size, episode_len=episode_len,
                   example_inds=[0, 1]))
    bad = {"steps": [{"observation": {"depth": np.zeros((4, 4))}, "action": np.zeros(2)}]}
    return eps + [bad] + list(gen(0, 1, image_size=image_size, episode_len=episode_len,
                                  example_inds=[5]))


def _same_tree(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        if f.name == "metadata.json":
            assert json.loads((a / f).read_text()) == json.loads((b / f).read_text())
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.fixture(scope="module")
def small_codec():
    """The small codec of tests/test_tokenizer.py: a JAX tree from a jitted
    init and the port's state dict from it (`params_from_flax`)."""
    jcfg = small_cfg()
    params = jax.jit(JaxVQModel(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    cfg = VQConfig(**{k: getattr(jcfg, k) for k in ("base_channels", "ch_mult",
                                                   "num_res_blocks", "z_channels")})
    return params, jcfg, params_from_flax(params), cfg


@pytest.mark.parametrize("encoder", ["raw", "magvit"])
def test_encode_episodes_matches_jax(encoder, small_codec, tmp_path):
    enc = jax_enc = None
    if encoder == "magvit":
        params, jcfg, state, cfg = small_codec
        enc = encode_openx.make_magvit_encoder(state, cfg, batch_size=8, device="cpu")
        jax_enc = jax_encode_openx.make_magvit_encoder(params, jcfg, batch_size=8,
                                                       dtype=jnp.float32)
    got = encode_openx.encode_episodes(_episodes(toyworld.toyworld_episode_generator),
                                       tmp_path / "port", "toyworld", encode_batch=enc,
                                       image_size=16)
    want = jax_encode_openx.encode_episodes(
        _episodes(jax_toyworld.toyworld_episode_generator), tmp_path / "jax", "toyworld",
        encode_batch=jax_enc, image_size=16)
    assert got == want and got["num_images"] == 30 and got["num_episodes"] == 3
    assert got["token_dtype"] == ("uint8" if encoder == "raw" else "uint32")
    if encoder == "magvit":
        assert got["vocab_size"] == 2**18 and got["h"] == got["w"] == 8
    _same_tree(tmp_path / "port", tmp_path / "jax")
    # no frames at all: both write error.json and return {}
    assert encode_openx.encode_episodes([], tmp_path / "e", "x") == {}
    assert (tmp_path / "e" / "error.json").is_file()


class _TinyJaxVAE(jax_svd_vae.SVDTemporalVAE):
    block_out: tuple = (32, 32)


def test_svd_encoder_matches_jax(monkeypatch):
    g = torch.Generator().manual_seed(4)
    vae = SVDTemporalVAE((32, 32), dtype=torch.float32, device="cpu", generator=g)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in vae.state_dict().items()}
    tree = jax_svd_vae.load_svd_vae_torch_weights(state, block_out=(32, 32), strict=True)
    monkeypatch.setattr(jax_svd_vae, "SVDTemporalVAE", _TinyJaxVAE)
    frames = np.random.default_rng(5).integers(0, 256, (6, 16, 16, 3)).astype(np.uint8)
    want = jax_encode_openx.make_svd_encoder(tree, batch_size=4)(frames)
    vae.load_state_dict(state)
    got = encode_openx.make_svd_encoder(vae, batch_size=4)(frames)
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (6, 4, 8, 8)
    # one float16 ulp, but near zero, where an ulp is finer than the two fp32
    # encoders' agreement (~1e-6 of max|z|), SVD_LATENT_TOL of max|z|
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
    assert (diff <= np.maximum(ulp, SVD_LATENT_TOL * np.abs(want).max())).all()
    assert (diff <= ulp).mean() >= 0.99


def _fake_tokens(frames):
    return (frames[:, ::2, ::2, 0].astype(np.uint32) * 977) % 2**18


_fake_tokens.vocab_size = 2**18


def _fake_latents(frames):
    return (frames[:, ::4, ::4].transpose(0, 3, 1, 2).astype(np.float32) / 37).astype(np.float16)


@pytest.mark.parametrize("kind", ["raw", "magvit", "vae"])
def test_merge_shards_matches_jax(kind, tmp_path):
    """Four shards of toyworld: shard 1 missing, shard 2 empty (error.json)."""
    enc = {"raw": None, "magvit": _fake_tokens, "vae": _fake_latents}[kind]
    n = 4
    for i in (0, 2, 3):
        eps = [] if i == 2 else jax_toyworld.toyworld_episode_generator(
            0, 1, image_size=16, episode_len=6, example_inds=[i, i + 10])
        jax_encode_openx.encode_episodes(
            eps, jax_merge_shards.SHARD_DATA_FORMAT.format(
                root=tmp_path, name="toyworld", suffix=kind, i=i, n=n, split="train"),
            "toyworld", encode_batch=enc, image_size=16)
    args = ["--dataset_name", "toyworld", "--suffix", kind, "--num_shards", str(n),
            "--root", str(tmp_path)]
    merge_shards.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_merge_shards.main(args + ["--out_dir", str(tmp_path / "jax")])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    meta = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert meta["num_images"] == 24 and meta["num_episodes"] == 4
    segs = np.fromfile(tmp_path / "port" / "segment_ids.bin", np.int32)
    np.testing.assert_array_equal(segs, np.repeat(np.arange(4), 6))
    assert merge_shards.SHARD_DATA_FORMAT == jax_merge_shards.SHARD_DATA_FORMAT
    with pytest.raises(FileNotFoundError):
        merge_shards.merge_shards([str(tmp_path / "none")], str(tmp_path / "x"))


def _tfds_stub(dataset_name, split, shard_ind, num_shards):
    """Stands in for TFDS: three 5-step episodes of 40x48 frames under an
    `observation` dict, with 3-dim actions."""
    rng = np.random.default_rng(shard_ind)
    for _ in range(3):
        yield {"steps": [{"observation": {"rgb": rng.integers(0, 256, (40, 48, 3))
                                          .astype(np.uint8)},
                          "action": rng.normal(size=3).astype(np.float32)}
                         for _ in range(5)]}


@pytest.mark.parametrize("entry", ["encode_openx", "encode_extern"])
def test_mains_match_jax(entry, tmp_path, monkeypatch, capsys):
    if entry == "encode_openx":
        monkeypatch.setattr(encode_openx, "tfds_episode_stream", _tfds_stub)
        monkeypatch.setattr(jax_encode_openx, "tfds_episode_stream", _tfds_stub)
        args = ["--dataset_name", "language_table", "--shard_ind", "1", "--num_shards", "3",
                "--encoder_type", "raw", "--keep_res"]
        port, ref = encode_openx.main, jax_encode_openx.main
        name = "language_table_raw_shard1_of_3_train"
    else:
        args = ["--dataset_name", "toyworld", "--encoder_type", "raw", "--num_shards", "60",
                "--shard_ind", "7", "--image_size", "64"]
        port, ref = encode_extern.main, jax_encode_extern.main
        name = "toyworld_raw_shard7_of_60_train"
    port(args + ["--out_root", str(tmp_path / "port"), "--device", "cpu"])
    ref(args + ["--out_root", str(tmp_path / "jax")])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed[0] == printed[1] and printed[0]["num_images"] > 0
    _same_tree(tmp_path / "port" / name, tmp_path / "jax" / name)
    assert (sorted(encode_extern.DATASET_TO_GEN_AND_SIZE.items())
            == sorted((k, (getattr(encode_extern, v[0].__name__), v[1]))
                      for k, v in jax_encode_extern.DATASET_TO_GEN_AND_SIZE.items()))


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (encode_openx.main, encode_extern.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--dataset_name", "toyworld", "--encoder_type", "raw",
                  "--out_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_openx.make_svd_encoder()
    assert not list(tmp_path.iterdir())
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)  # import fails
    with pytest.raises(ImportError, match="tensorflow_datasets"):
        next(encode_openx.tfds_episode_stream("fractal20220817_data", "train", 0, 1))
