"""The port's pixel-side CLIs on the CPU: `train_tokenizer --device cpu`
(4 steps of a small 16x codec on 64² frames with a VGG LPIPS) draws
hma_tpu's batches and writes a directory that `load_magvit2` reads (its EMA
by default), `evaluate --tokenizer_ckpt` and `train_multi
--tokenizer_checkpoint` too; the trainer's `vis/rollout_psnr` and
`vis/rollout_lpips` equal hma_tpu's formula (its decoder, `batch_psnr` and
AlexNet LPIPS on the same weights) on the same rollout tokens;
`visualize` on a token stream and on a latent stream writes the files
hma_tpu.visualize writes, with the same frames; a directory of hma_tpu's
orbax checkpoints is refused."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from hma_tpu import visualize as jax_visualize
from hma_tpu.data.datasets import RawImageDataset as JaxRawImageDataset
from hma_tpu.metrics.image import batch_psnr as jax_batch_psnr
from hma_tpu.metrics.lpips import LPIPS as JaxLPIPS
from hma_tpu.metrics.lpips import load_lpips_torch_weights as jax_load_lpips
from hma_tpu.metrics.lpips import make_lpips_fn as jax_make_lpips_fn
from hma_tpu.rollout import decode as jax_decode
from hma_tpu.tokenizer import convert as jax_convert
from hma_tpu.tokenizer.convert import torch_state_dict_to_flax
from hma_tpu.tokenizer.magvit2 import VQConfig as JaxVQConfig
from hma_tpu.tokenizer.svd_vae import SVDTemporalVAE as JaxSVDTemporalVAE
from hma_tpu.tokenizer.svd_vae import load_svd_vae_torch_weights
from hma_tpu_torch import train_tokenizer, visualize
from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.metrics.lpips import LPIPS
from hma_tpu_torch.rollout import decode as port_decode
from hma_tpu_torch.tokenizer.convert import TOKENIZER_FILE, load_magvit2
from hma_tpu_torch.tokenizer.magvit2 import VQConfig
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main

# a 16x codec (four downsamplings): the tiny card's 4x4 tokens <-> 64² frames
TOK = dict(base_channels=16, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, disc_ndf=8,
           disc_num_layers=2)
SIDE = 64
# the two packages' fp32 decoders truncate to uint8 after summing in other
# orders, so a pixel may differ by a level: visualize's frames are held to
# PIXEL_LEVELS (the CPU reads 1 level at 2.4e-5 of the codec's pixels, none
# of the VAE's), the rollout PSNR and LPIPS to METRIC_RTOL (reads 5.5e-7 and
# 7.9e-7)
PIXEL_LEVELS = 1
METRIC_RTOL = 1e-5


def _lpips_file(path, net, seed):
    sd = LPIPS(net, device="cpu", generator=torch.Generator().manual_seed(seed)).state_dict()
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def tok_env(tmp_path_factory):
    """train_tokenizer's 4 steps (step_2, step_4 and final_checkpt) on a
    synthetic 64² raw-image set, the images each step got recorded."""
    root = tmp_path_factory.mktemp("tok")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, SIDE, SIDE, 3)).astype(np.uint8)
    write_token_dataset(root / "raw", frames, np.zeros(12), None, {"name": "raw"})
    VQConfig(**TOK).save_pretrained(root / "vq.json")
    _lpips_file(root / "vgg.pt", "vgg", seed=1)
    seen = []
    make_step = train_tokenizer.make_vq_train_step

    def recording(*a, **kw):
        step = make_step(*a, **kw)
        return lambda images: (seen.append(images.clone()), step(images))[1]

    mp = pytest.MonkeyPatch()
    mp.setattr(train_tokenizer, "make_vq_train_step", recording)
    try:
        train_tokenizer.main([
            "--train_data_dir", str(root / "raw"), "--output_dir", str(root / "tok"),
            "--vq_config", str(root / "vq.json"), "--batch_size", "2", "--max_train_steps", "4",
            "--checkpointing_steps", "2", "--log_every", "1", "--warmup_steps", "1",
            "--learning_rate", "1e-3", "--lpips_weights", str(root / "vgg.pt"), "--seed", "5",
            "--image_size", str(SIDE), "--device", "cpu"])
    finally:
        mp.undo()
    return root, seen


def test_train_tokenizer_writes_what_load_magvit2_reads(tok_env):
    root, _ = tok_env
    out = root / "tok"
    assert sorted(p.name for p in out.iterdir()) == [
        "final_checkpt", "metrics.jsonl", "step_2", "step_4", "vq_config.json"]
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    logs = [l for l in lines if "tok/total_loss" in l]
    assert [l["_step"] for l in logs] == [1, 2, 3, 4]
    assert all(np.isfinite(l[k]) for l in logs for k in l if k.startswith("tok/"))
    assert all(l["tok/perceptual_loss"] > 0 for l in logs)  # the VGG LPIPS is on

    saved = torch.load(out / "step_4" / TOKENIZER_FILE, weights_only=True)
    state, cfg = load_magvit2(str(out))  # the newest step tag, EMA weights
    assert dataclasses.asdict(cfg) == dataclasses.asdict(VQConfig(**TOK))
    assert state.keys() == saved["ema"].keys() == saved["gen"].keys()
    assert all(torch.equal(state[k], saved["ema"][k]) for k in state)
    gen, _ = load_magvit2(str(out), use_ema=False)
    assert all(torch.equal(gen[k], saved["gen"][k]) for k in gen)
    assert any(not torch.equal(gen[k], state[k]) for k in gen)
    final, _ = load_magvit2(str(out / "final_checkpt"))
    assert all(torch.equal(final[k], state[k]) for k in state)  # no step after step_4
    early, _ = load_magvit2(str(out / "step_2"))
    assert any(not torch.equal(early[k], state[k]) for k in state)
    # the sidecar loads into hma_tpu's VQConfig as well (its other fields at
    # their defaults)
    want = dataclasses.asdict(JaxVQConfig())
    want.update(dataclasses.asdict(cfg))
    assert dataclasses.asdict(JaxVQConfig.from_pretrained(out / "vq_config.json")) == want


def test_train_tokenizer_draws_hma_tpus_batches(tok_env):
    root, seen = tok_env
    ds = JaxRawImageDataset(root / "raw", window_size=1, compute_stride_from_freq_table=False,
                            filter_interrupts=False)
    rng = np.random.default_rng(5)
    assert len(seen) == 4
    for images in seen:
        idx = rng.integers(0, len(ds), 2)
        want = np.asarray(jnp.asarray(np.stack([ds[int(i)]["images"][0] for i in idx]),
                                      jnp.float32) / 127.5 - 1.0)
        np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(), want)


def test_train_tokenizer_refuses_another_image_size(tok_env, tmp_path):
    root, _ = tok_env
    with pytest.raises(ValueError, match=f"are {SIDE}x{SIDE}"):
        train_tokenizer.main(["--train_data_dir", str(root / "raw"), "--output_dir",
                              str(tmp_path / "tok"), "--image_size", str(2 * SIDE),
                              "--device", "cpu"])


def test_visualize_refuses_a_stride():
    assert visualize.parse_args(["--token_dir", "gen", "--stride", "1"]).stride == 1
    with pytest.raises(SystemExit):
        visualize.parse_args(["--token_dir", "gen", "--stride", "2"])


def test_orbax_tokenizer_directory_is_refused(tmp_path):
    (tmp_path / "run" / "step_10" / "state").mkdir(parents=True)
    VQConfig().save_pretrained(tmp_path / "run" / "vq_config.json")
    for path in (tmp_path / "run", tmp_path / "run" / "step_10"):
        with pytest.raises(NotImplementedError, match="orbax"):
            load_magvit2(str(path))


# ------------------------------------------------ the trainer's pixel metrics

@pytest.fixture(scope="module")
def card_env(tmp_path_factory):
    """The tiny card (2 layers, d 32, T 4, 4x4 tokens) and a one-domain
    token set whose tokens the 16x codec decodes to 64² frames."""
    root = tmp_path_factory.mktemp("vis_train")
    rng = np.random.default_rng(1)
    vocab = 2**18
    for split in ("train", "val"):
        write_token_dataset(root / f"dom_magvit_max1000000_{split}",
                            rng.integers(0, vocab, (40, 4, 4)).astype(np.uint32),
                            np.repeat(np.arange(4), 10), rng.normal(size=(40, 2)).astype(
                                np.float32), {"name": "dom", "vocab_size": vocab, "s": 16})
    GenieConfig(num_layers=2, num_heads=2, d_model=32, T=4, S=16, image_vocab_size=vocab,
                num_factored_vocabs=2, action_token_size=8, action_network="concat+modulate",
                num_prompt_frames=2, use_actions=True).save_pretrained(str(root / "card.json"))
    (root / "split.yaml").write_text(yaml.safe_dump({"domains": "dom"}))
    return root


def _jax_decoder(state, cfg):
    return jax_decode.make_token_decoder(
        torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()}, use_ema=False),
        JaxVQConfig(**dataclasses.asdict(cfg)), dtype=jnp.float32)


def _assert_frames_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and diff.max() <= PIXEL_LEVELS


def test_trainer_pixel_metrics_match_jax(tok_env, card_env, monkeypatch, tmp_path):
    tok_dir = tok_env[0] / "tok"
    alex = _lpips_file(tmp_path / "alex.pt", "alex", seed=2)
    rollouts = []
    generate = trainer.generate_tokens

    def recording(model, tokens, *a, **kw):
        out = generate(model, tokens, *a, **kw)
        rollouts.append((tokens.clone(), out.clone()))
        return out

    monkeypatch.setattr(trainer, "generate_tokens", recording)
    train_main(["--genie_config", str(card_env / "card.json"), "--output_dir",
                str(tmp_path / "run"), "--train_split", str(card_env / "split.yaml"),
                "--data_root", str(card_env), "--window_size", "4",
                "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
                "--max_train_steps", "2", "--vis_every_n_steps", "1", "--eval_every_n_steps",
                "2", "--max_eval_steps", "1", "--log_every", "1", "--num_warmup_steps", "1",
                "--tokenizer_checkpoint", str(tok_dir), "--lpips_weights",
                str(tmp_path / "alex.pt"), "--device", "cpu"])
    vis = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
           if "vis/rollout_psnr" in l]
    assert len(vis) == 1 and len(rollouts) == 1 and vis[0]["_step"] == 1

    # hma_tpu's formula (trainer.py rollout_eval) on the same tokens
    labels, out = (x.numpy() for x in rollouts[0])
    gen, gt = out[:, 2:].reshape(-1, 4, 4), labels[:, 2:].reshape(-1, 4, 4)
    decode = _jax_decoder(*load_magvit2(str(tok_dir)))
    pred_px, gt_px = decode(gen), decode(gt)
    assert pred_px.shape == (4, SIDE, SIDE, 3)
    want_psnr = float(np.mean(jax_batch_psnr(pred_px, gt_px)))
    want_lpips = float(np.mean(jax_make_lpips_fn(
        jax_load_lpips(JaxLPIPS(net="alex"), {k: v.numpy() for k, v in alex.items()}),
        net="alex")(pred_px, gt_px)))
    np.testing.assert_allclose(vis[0]["vis/rollout_psnr"], want_psnr, rtol=METRIC_RTOL)
    np.testing.assert_allclose(vis[0]["vis/rollout_lpips"], want_lpips, rtol=METRIC_RTOL)
    assert vis[0]["vis/rollout_token_match"] == float((gen == gt).mean())

    # evaluate reads the train_tokenizer directory too
    got = evaluate_main(["--checkpoint_dir", str(tmp_path / "run"), "--val_data_dir",
                         str(card_env / "dom_magvit_max1000000_val"), "--output_dir",
                         str(tmp_path / "eval"), "--batch_size", "2", "--max_examples", "2",
                         "--tokenizer_ckpt", str(tok_dir), "--device", "cpu"])
    assert np.isfinite(got["psnr"]) and np.isfinite(got["ssim"])


# ------------------------------------------------------------- visualize

def _small_vae_decoders(seed=4):
    """The same block_out (32, 32) SVD-VAE weights as hma_tpu and port
    `load_svd_decoder` stand-ins (the released width takes a 390 MB file)."""
    vae = SVDTemporalVAE((32, 32), dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(seed)).eval()
    tree = load_svd_vae_torch_weights(vae.state_dict(), block_out=(32, 32), strict=True)
    jm = JaxSVDTemporalVAE(block_out=(32, 32))

    def port(path, dtype=None, device=None):
        return lambda z: vae.decode(torch.as_tensor(z)).detach().numpy()

    def jax_(path):
        return lambda z: jm.apply(tree, z, method=JaxSVDTemporalVAE.decode)

    return port, jax_


@pytest.mark.parametrize("stream", ["tokens", "latents"])
def test_visualize_matches_jax(stream, tok_env, monkeypatch, tmp_path):
    rng = np.random.default_rng(6)
    n_ex, P, W = 3, 2, 4
    per_ex = P + 2 * (W - P)
    meta = {"num_prompt_frames": P, "window_size": W, "num_images": n_ex * per_ex}
    if stream == "tokens":
        ckpt = str(tok_env[0] / "tok")
        video = rng.integers(0, 2**18, (n_ex * per_ex, 4, 4)).astype(np.uint32)
        meta.update(h=4, w=4, token_dtype="uint32")
        decoder = _jax_decoder(*load_magvit2(ckpt))
        monkeypatch.setattr(jax_decode, "make_token_decoder", lambda params, config: decoder)
        monkeypatch.setattr(jax_convert, "load_magvit2", lambda path: (None, None))
    else:
        ckpt = str(tmp_path / "vae.pt")  # never read: both loaders are stand-ins
        video = (30 * rng.normal(size=(n_ex * per_ex, 4, 2, 2))).astype(np.float16)
        meta.update(h=2, w=2, latent_channels=4)
        port, jax_ = _small_vae_decoders()
        monkeypatch.setattr(port_decode, "load_svd_decoder", port)
        monkeypatch.setattr(jax_decode, "load_svd_decoder", jax_)
    tokens = tmp_path / "gen"
    tokens.mkdir()
    video.tofile(tokens / "video.bin")
    (tokens / "metadata.json").write_text(json.dumps(meta))

    args = ["--token_dir", str(tokens), "--tokenizer_ckpt", ckpt, "--max_examples", "2",
            "--offset", "1"]
    visualize.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_visualize.main([*args, "--output_dir", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == [
        "example_1.gif", "example_1_comic.png", "example_2.gif", "example_2_comic.png"]
    for name in names:
        a, b = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert a.size == b.size and getattr(a, "n_frames", 1) == getattr(b, "n_frames", 1)
        if name.endswith(".png"):  # every frame of the example, lossless
            _assert_frames_close(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))

    # decode_examples: the frames the files are made of
    parsed = visualize.parse_args([*args, "--device", "cpu"])
    frames = list(visualize.decode_examples(parsed))
    assert [i for i, *_ in frames] == [1, 2]
    side = SIDE if stream == "tokens" else 4  # block_out (32, 32): a 2x VAE
    assert all(px.shape == (per_ex, side, side, 3) and px.dtype == np.uint8
               for _, px, *_ in frames)
