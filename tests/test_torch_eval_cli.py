"""The port's evaluation CLIs on the CPU (`--device cpu`), on tiny
checkpoints and synthetic datasets: `evaluate`'s teacher-forced JSON equals
hma_tpu's teacher_forced_logits + teacher_forced_metrics on the converted
weights (the first-step logits decode fully masked frames, so no random
draw enters them); `--autoregressive_time`, `evaluate_feature` in both modes
and its latent FID/FVD equal the port's own functions under the CLI's seed;
`--use_feature` forwards every flag as hma_tpu's does; the pixel metrics
of `--tokenizer_ckpt` (and `--raw_image_data`) equal hma_tpu.evaluate.main's
on the same fp32 model and codec, and ΔPSNR the port's own perturbed
rollouts; what is not ported raises, a missing weights file raises before
the evaluation runs, and so does a run without a card and without
`--device`."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu import evaluate as jax_evaluate
from hma_tpu import evaluate_feature as jax_evaluate_feature
from hma_tpu.metrics.token import teacher_forced_metrics as jax_teacher_forced_metrics
from hma_tpu.data import encode_openx as jax_encode_openx
from hma_tpu.rollout import decode as jax_decode
from hma_tpu.rollout.maskgit import teacher_forced_logits as jax_teacher_forced_logits
from hma_tpu_torch import evaluate_feature as port_evaluate_feature
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.data.datasets import RawFeatureDataset, RawTokenDataset, write_token_dataset
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.evaluate_diffusion import main as evaluate_diffusion_main
from hma_tpu_torch.evaluate_feature import flat_embed, load_mar_model
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
from hma_tpu_torch.generate import load_model
from hma_tpu_torch.metrics.fid import fid_from_features
from hma_tpu_torch.metrics.fvd import calculate_fvd
from hma_tpu_torch.metrics.image import batch_psnr
from hma_tpu_torch.metrics.token import teacher_forced_metrics
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.parallel.distributed import init_distributed
from hma_tpu_torch.rollout.mar import generate_latents, teacher_forced_latents
from hma_tpu_torch.rollout.decode import make_token_decoder
from hma_tpu_torch.rollout.maskgit import autoregressive_logits, teacher_forced_logits
from hma_tpu_torch.tokenizer.convert import load_magvit2
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from torch_port_helpers import build_pair, port_model, tiny_card, tiny_mar_card

B = 2


def _dataset(path, rng, n, frame_shape, dtype, d_action, meta):
    video = (rng.integers(0, 2**18, (n, *frame_shape)) if dtype == np.uint32
             else rng.normal(size=(n, *frame_shape))).astype(dtype)
    segs = np.repeat(np.arange(n // 10), 10).astype(np.int32)
    actions = rng.normal(size=(n, d_action)).astype(np.float32)
    write_token_dataset(path, video, segs, actions, {"name": "a", **meta})
    return path


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A token dataset and a converted checkpoint of the tiny discrete card."""
    root = tmp_path_factory.mktemp("port_eval")
    card = tiny_card()
    data = _dataset(root / "data", np.random.default_rng(7), 30, (4, 4), np.uint32,
                    card["d_actions"][0], {"vocab_size": card["image_vocab_size"]})
    jm, params, _, _, _ = build_pair()
    save_checkpoint(str(root), "ckpt", params_from_jax(params, GenieConfig(**card)),
                    GenieConfig(**card))
    return root, data, jm, params


@pytest.fixture(scope="module")
def feature_env(tmp_path_factory):
    """A latent dataset and an STMAR checkpoint of the tiny continuous card
    with `jointly_predict_actions`, whose unconditional branch cfg needs."""
    root = tmp_path_factory.mktemp("port_eval_feature")
    card = tiny_mar_card(jointly_predict_actions=True)
    data = _dataset(root / "data", np.random.default_rng(11), 30, (4, 4, 4), np.float16,
                    card["d_actions"][0], {"latent_channels": 4})
    tm = port_model(STMAR, card)  # the CLI is held to the port's functions
    save_checkpoint(str(root), "ckpt", tm.state_dict(), DiffusionGenieConfig(**card))
    return root, data


def _args(root, data, out, *extra):
    return ["--checkpoint_dir", str(root / "ckpt"), "--val_data_dir", str(data),
            "--output_dir", str(root / out), "--batch_size", str(B), *extra]


def _token_batch(data, n, T, offset=0):
    ds = RawTokenDataset(data, window_size=T, use_actions=True, name="a")
    items = [ds[offset + i] for i in range(n)]
    tokens = np.stack([it["input_ids"] for it in items]).reshape(n, T, -1)
    return tokens, np.stack([it["action_ids"] for it in items]).astype(np.float32)


def test_evaluate_teacher_forced_matches_jax(env, capsys):
    root, data, jm, params = env
    got = evaluate_main(_args(root, data, "tf", "--max_examples", "4", "--device", "cpu",
                              "--save_outputs_dir", str(root / "dump")))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == {"loss", "perplexity", "acc", "gen_time", "num_examples"}
    assert got["num_examples"] == 4 and got["gen_time"] > 0

    # the JSON holds the mean over its two batches of each batch's metrics
    tokens, actions = _token_batch(data, 4, jm.config.T)

    @jax.jit
    def jax_metrics(tokens, actions):
        _, logits = jax_teacher_forced_logits(
            jm, params, tokens, actions, jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0),
            maskgit_steps=2, temperature=0.0)
        return jax_teacher_forced_metrics(logits, tokens[:, 1:],
                                          jm.config.factored_vocab_size)

    batches = [jax_metrics(jnp.asarray(tokens[i:i + B], jnp.int32), actions[i:i + B])
               for i in (0, B)]
    for k in ("loss", "perplexity", "acc"):
        want = np.mean([float(m[k]) for m in batches])
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-7)

    for n in (0, 2):
        gt, pred = np.load(root / "dump" / f"gt_{n}_r0.npy"), np.load(root / "dump" / f"pred_{n}_r0.npy")
        np.testing.assert_array_equal(gt, tokens[n:n + B])
        assert pred.shape == (B, jm.config.T - 1, 16) and (pred < 2**18).all()


def test_evaluate_autoregressive_equals_port_functions(env):
    root, data, jm, _ = env
    got = evaluate_main(_args(root, data, "ar", "--max_examples", str(B), "--device",
                              "cpu", "--autoregressive_time", "--num_prompt_frames", "2",
                              "--seed", "3"))
    model, config = load_model(str(root / "ckpt"), "cpu", torch.float32)
    tokens, actions = _token_batch(data, B, config.T)
    x = torch.from_numpy(tokens.astype(np.int64))
    _, logits = autoregressive_logits(model, x, 2, torch.from_numpy(actions), 0,
                                      torch.Generator().manual_seed(3), maskgit_steps=2)
    want = teacher_forced_metrics(logits, x[:, 1:], config.factored_vocab_size)
    assert {k: got[k] for k in want} == {k: float(v) for k, v in want.items()}
    assert got["num_examples"] == B


def _latent_batch(data, n, T, offset=0):
    ds = RawFeatureDataset(data, window_size=T, use_actions=True, domain="a")
    items = [ds[offset + i] for i in range(n)]
    lat = np.stack([it["input_ids"] for it in items]).reshape(n, T, 4, 4, 4)
    acts = np.stack([it["action_ids"] for it in items]).astype(np.float32)
    return torch.from_numpy(lat), torch.from_numpy(acts)


def _predict(model, lat, acts, mode, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    if mode == "teacher_forced":
        return torch.cat([lat[:, :1], teacher_forced_latents(model, lat, acts, 0, gen, **kw)], 1)
    return generate_latents(model, lat, 2, acts, 0, gen, **kw)


@pytest.mark.parametrize("mode,cfg", [("teacher_forced", "1.0"), ("autoregressive", "2.0")])
def test_evaluate_feature_equals_port_functions(feature_env, mode, cfg):
    root, data = feature_env
    args = _args(root, data, mode, "--max_examples", str(B), "--device", "cpu",
                 "--num_prompt_frames", "2", "--seed", "5", "--cfg", cfg,
                 "--eval_mode", mode, "--compute_fid")
    got = evaluate_feature_main(args)
    model, config = load_mar_model(str(root / "ckpt"), "cpu", torch.float32)
    lat, acts = _latent_batch(data, B, config.T)
    t_first = 1 if mode == "teacher_forced" else 2
    kw = dict(temperature=1.0, cfg=float(cfg))
    err = (_predict(model, lat, acts, mode, 5, **kw)[:, t_first:] - lat[:, t_first:]) ** 2
    assert got["latent_mse"] == err.mean().item()
    np.testing.assert_allclose(got["latent_mse_per_frame"],
                               err.mean(dim=(0, 2, 3, 4)).double().numpy(), rtol=1e-12)
    assert len(got["latent_mse_per_frame"]) == config.T - t_first
    assert got["num_examples"] == B and got["gen_time"] > 0
    second = _predict(model, lat, acts, mode, 100, **kw).numpy()  # seed FID_SEED + 0
    flat = lambda v: flat_embed(v.reshape(-1, *v.shape[2:]))
    assert got["fid_latent"] == fid_from_features(flat(second), flat(lat.numpy()))
    assert "fvd_latent" not in got  # T 4 < 10

    if mode == "autoregressive":  # evaluate --use_feature is evaluate_feature
        via = evaluate_main(_args(root, data, "via", "--max_examples", str(B), "--device",
                                  "cpu", "--num_prompt_frames", "2", "--seed", "5",
                                  "--temperature", "1.0", "--autoregressive_time",
                                  "--use_feature", "--cfg", cfg, "--compute_fid"))
        assert {k: v for k, v in via.items() if k != "gen_time"} == \
            {k: v for k, v in got.items() if k != "gen_time"}


def test_evaluate_feature_fvd_latent_at_ten_frames(tmp_path):
    card = tiny_mar_card(T=10)
    data = _dataset(tmp_path / "data", np.random.default_rng(2), 40, (4, 4, 4),
                    np.float16, card["d_actions"][0], {"latent_channels": 4})
    cfg = DiffusionGenieConfig(**card)
    model = STMAR(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), "ckpt", model.state_dict(), cfg)
    # three windows in batches of 2 and 1
    got = evaluate_diffusion_main(_args(tmp_path, data, "out", "--max_examples", "3",
                                        "--device", "cpu", "--maskgit_steps", "2",
                                        "--compute_fvd"))
    model.eval()
    preds, gts = [], []
    for i, n in ((0, 2), (2, 1)):  # the FID/FVD pass seeds batch i with FID_SEED + i
        lat, acts = _latent_batch(data, n, 10, offset=i)
        preds.append(_predict(model, lat, acts, "teacher_forced", 100 + i,
                              maskgit_steps=2).numpy())
        gts.append(lat.numpy())
    want = calculate_fvd(np.concatenate(preds), np.concatenate(gts), flat_embed)
    assert got["fvd_latent"] == want and "fid_latent" not in got
    assert got["num_examples"] == 3


@pytest.fixture(scope="module")
def pixel_env(env, tmp_path_factory):
    """A MagVit2 `.ckpt` of the small codec (4x4 token grids <-> 8x8 frames,
    the tiny card's), its sidecar config, and a raw-image dataset of 8x8
    uint8 frames."""
    root = tmp_path_factory.mktemp("port_eval_pixels")
    vq_cfg = VQConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    vq = VQModel(vq_cfg, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    torch.save({"state_dict": vq.state_dict()}, root / "tok.ckpt")
    vq_cfg.save_pretrained(str(root / "tok.ckpt.json"))
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (30, 8, 8, 3)).astype(np.uint8)
    write_token_dataset(root / "raw", frames, np.repeat(np.arange(3), 10).astype(np.int32),
                        rng.normal(size=(30, 4)).astype(np.float32), {"name": "a"})
    return root / "tok.ckpt", root / "raw"


PIXEL_KEYS = ("psnr", "ssim", "psnr_copy_prev", "psnr_vs_copy")


@pytest.mark.parametrize("raw", [False, True])
def test_evaluate_pixel_metrics_match_jax(env, pixel_env, monkeypatch, raw):
    """At 1 MaskGIT step and temperature 0 no draw enters the samples, so
    hma_tpu.evaluate.main on the same fp32 model and codec gives the same
    pixel metrics (its model, decoder and encoder held to fp32 here)."""
    root, data, jm, params = env
    tok_ckpt, raw_data = pixel_env
    flags = ["--checkpoint_dir", str(root / "ckpt"),
             "--val_data_dir", str(raw_data if raw else data), "--batch_size", "2",
             "--max_examples", "4", "--maskgit_steps", "1", "--temperature", "0",
             "--tokenizer_ckpt", str(tok_ckpt), "--num_action_trials", "0",
             *(["--raw_image_data"] if raw else [])]
    got = evaluate_main([*flags, "--output_dir", str(root / f"px{raw}"), "--device", "cpu"])
    monkeypatch.setattr(jax_evaluate, "load_model", lambda d: (jm, params, jm.config))
    monkeypatch.setattr(jax_decode, "make_token_decoder", functools.partial(
        jax_decode.make_token_decoder, dtype=jnp.float32))
    monkeypatch.setattr(jax_encode_openx, "make_magvit_encoder", functools.partial(
        jax_encode_openx.make_magvit_encoder, dtype=jnp.float32))
    want = jax_evaluate.main([*flags, "--output_dir", str(root / f"jpx{raw}")])
    assert set(got) == set(want)  # no delta_psnr without trials
    for k in (*PIXEL_KEYS, "loss", "acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    assert got["dec_time"] > 0 and got["num_examples"] == 4


def test_evaluate_delta_psnr_is_psnr_less_perturbed_rollouts(env, pixel_env):
    root, data, _, _ = env
    tok_ckpt, _ = pixel_env
    got = evaluate_main(_args(root, data, "dpsnr", "--max_examples", str(B), "--device", "cpu",
                              "--tokenizer_ckpt", str(tok_ckpt), "--num_action_trials", "2",
                              "--perturbation_scale", "0.5", "--seed", "7"))
    model, config = load_model(str(root / "ckpt"), "cpu", torch.float32)
    decode = make_token_decoder(*load_magvit2(str(tok_ckpt)), device="cpu")
    tokens, actions = _token_batch(data, B, config.T)
    x, acts = torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(actions)
    gen = torch.Generator().manual_seed(7)
    frames = lambda tok: decode(tok.reshape(-1, config.h, config.w))
    gt = frames(x[:, 1:])
    samples, _ = teacher_forced_logits(model, x, acts, 0, gen)
    psnr = np.mean(batch_psnr(frames(samples), gt))
    rand = []
    for _ in range(2):  # the CLI draws each trial's noise, then its rollout, from one generator
        moved = acts + 0.5 * torch.randn(acts.shape, generator=gen)
        rand.append(np.mean(batch_psnr(frames(teacher_forced_logits(model, x, moved, 0, gen)[0]),
                                       gt)))
    assert got["psnr"] == pytest.approx(psnr, rel=1e-12)
    assert got["delta_psnr"] == pytest.approx(psnr - np.mean(rand), rel=1e-12, abs=1e-12)
    assert got["delta_psnr"] != 0.0


def test_use_feature_forwards_every_flag(monkeypatch):
    flags = ["--checkpoint_dir", "ck", "--val_data_dir", "val", "--output_dir", "o",
             "--domain", "a", "--batch_size", "3", "--maskgit_steps", "5",
             "--temperature", "0.5", "--max_examples", "7", "--autoregressive_time",
             "--num_prompt_frames", "2", "--seed", "9", "--fsdp", "1", "--tp", "1",
             "--sp", "1", "--use_wandb", "--cfg", "2.0", "--compute_fid"]
    seen = {}
    monkeypatch.setattr(port_evaluate_feature, "main", lambda argv: seen.setdefault("port", argv))
    monkeypatch.setattr(jax_evaluate_feature, "main", lambda argv: seen.setdefault("jax", argv))
    evaluate_main([*flags, "--use_feature", "--device", "cpu"])
    jax_evaluate.main([*flags, "--use_feature"])
    rest = flags[-3:]  # the flags evaluate's parser does not know come last
    assert seen["jax"][-3:] == rest
    assert seen["port"] == [*seen["jax"][:-3], "--device", "cpu", *rest]
    # what evaluate_feature's own parser makes of them
    args = port_evaluate_feature.parse_args(seen["port"])
    assert (args.domain, args.batch_size, args.maskgit_steps, args.temperature,
            args.max_examples, args.num_prompt_frames, args.seed, args.eval_mode,
            args.use_wandb, args.device, args.cfg, args.compute_fid) == \
        ("a", 3, 5, 0.5, 7, 2, 9, "autoregressive", True, "cpu", 2.0, True)


# --sp runs (tests/test_torch_sp.py); in one process it asks for processes
# that are not there. Those two cases keep the ids they had while --sp was
# refused as item 10c.
@pytest.mark.parametrize("cli,extra,error,match", [
    ("evaluate", ["--tokenizer_ckpt", "{tmp}"], FileNotFoundError, "no tokenizer checkpoint"),
    ("evaluate", ["--raw_image_data"], ValueError, "requires --tokenizer_ckpt"),
    ("evaluate", ["--use_wandb"], NotImplementedError, "item 11"),
    pytest.param("evaluate", ["--sp", "2"], ValueError, "world has 1",
                 id="evaluate-extra3-NotImplementedError-item 10c"),
    ("evaluate", ["--cfg", "2.0"], ValueError, "unknown arguments"),
    ("evaluate_feature", ["--vae_checkpoint", "{tmp}/v.pt"], FileNotFoundError, "v.pt"),
    ("evaluate_feature", ["--i3d_weights", "{tmp}/i.pt"], FileNotFoundError, "i.pt"),
    ("evaluate_feature", ["--use_wandb"], NotImplementedError, "item 11"),
    pytest.param("evaluate_feature", ["--sp", "2"], ValueError, "world has 1",
                 id="evaluate_feature-extra8-NotImplementedError-item 10c")])
def test_unsupported_flags_raise(tmp_path, cli, extra, error, match):
    main = evaluate_main if cli == "evaluate" else evaluate_feature_main
    with pytest.raises(error, match=match):
        main(["--checkpoint_dir", str(tmp_path), "--val_data_dir", str(tmp_path),
              "--output_dir", str(tmp_path / "o"), "--device", "cpu",
              *(x.format(tmp=tmp_path) for x in extra)])


def test_more_than_one_process_raises(monkeypatch):
    """More than one process is ported (tests/test_torch_data_parallel.py
    runs two); what cannot start one raises instead of running alone: a
    world of two with no process id, and TPU metadata discovery."""
    assert init_distributed() is False
    monkeypatch.setenv("HMA_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("HMA_TPU_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="process id"):
        init_distributed(device="cpu")
    monkeypatch.setenv("HMA_TPU_COORDINATOR", "auto")
    with pytest.raises(NotImplementedError, match="metadata"):
        init_distributed(device="cpu")


def test_clis_without_device_raise_on_cpu_host(env, feature_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, data, _, _ = env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_main(_args(root, data, "nodev"))
    froot, fdata = feature_env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_feature_main(_args(froot, fdata, "nodev"))


def test_loaders_take_the_newest_step_and_refuse_the_other_family(env, feature_env, tmp_path):
    root, _, _, _ = env
    model, _ = load_model(str(root / "ckpt"), "cpu", torch.float32)
    state = model.state_dict()
    cfg = GenieConfig(**tiny_card())
    save_checkpoint(str(tmp_path), "step_1", state, cfg)
    newer = {k: v + 1 for k, v in state.items()}
    save_checkpoint(str(tmp_path), "step_2", newer, cfg)
    loaded, _ = load_model(str(tmp_path), "cpu", torch.float32)
    assert all(torch.equal(loaded.state_dict()[k], newer[k]) for k in newer)
    froot, _ = feature_env
    with pytest.raises(ValueError, match="continuous"):
        load_model(str(froot / "ckpt"), "cpu", torch.float32)
    with pytest.raises(ValueError, match="discrete"):
        load_mar_model(str(root / "ckpt"), "cpu", torch.float32)
