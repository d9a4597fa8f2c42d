"""The port's FID and FVD backbones against hma_tpu's, on the CPU in fp32:
InceptionV3 at its smallest input (75²) with live BatchNorm statistics,
I3D's mean-pool head and its styleganv logits head, the resize and crop of
both embeddings in both directions against `jax.image.resize`, the videogpt
I3D embedding end to end at 32², `calculate_fvd` (styleganv at 224²) with
the same converted weights, and `evaluate_feature
--vae_checkpoint --compute_fid` on the tiny STMAR card: its pixel fid is
the port's library functions' on the clips it decoded, and hma_tpu's
calculate_fid on those clips with the same converted Inception weights.
No flax `init` runs: each JAX tree comes from a port state dict through
hma_tpu's importer (`load_inception_torch_weights`, `load_i3d_torch_weights`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.metrics import fid as jax_fid
from hma_tpu.metrics import fvd as jax_fvd
from hma_tpu_torch import evaluate_feature as port_evaluate_feature
from hma_tpu_torch.config import DiffusionGenieConfig
from hma_tpu_torch.data.datasets import RawFeatureDataset, write_token_dataset
from hma_tpu_torch.evaluate_feature import FID_SEED, load_mar_model
from hma_tpu_torch.metrics.fid import (
    InceptionV3FID,
    backbone,
    calculate_fid,
    inception_inputs,
)
from hma_tpu_torch.metrics.fvd import InceptionI3D, calculate_fvd, i3d_inputs, make_i3d_embed_fn
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.rollout.decode import decode_clips, load_svd_decoder
from hma_tpu_torch.rollout.mar import teacher_forced_latents
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from torch_port_helpers import tiny_mar_card

# of max|feature|, fp32 both sides, BatchNorm statistics live: the nets read
# 1.2e-6 to 5.4e-6
FEAT_TOL = 5e-5
# absolute, on the [-1, 1] inputs the resize makes (~6e-3 of a uint8 level);
# reads 3.6e-7 upsampling, 5e-7 (256 -> 224) to 2.4e-5 (320 -> 299) shrinking
PIX_TOL = 5e-5
FVD_RTOL = 1e-5  # relative; styleganv on two clips a side reads 5.3e-7
# relative; the CLI's fid (4 frames a side, 2048-d, the seeded Inception,
# whose features barely differ between inputs: fid ~1.4e-6) reads 3.3e-6
FID_RTOL = 1e-4


def _live_backbone(make, seed, calib_shape):
    """(state dict, JAX tree) of the port net `make()` drawn from `seed`,
    its BatchNorm statistics taken from a batch of noise of `calib_shape`
    (N, C, ...) and its BatchNorm scales and biases moved off 1 and 0. With
    the identity statistics of a fresh net the global pool leaves features
    that differ between inputs by ~1e-4 of their size; with these, by ~0.2,
    as a trained net's do."""
    model = backbone(make, None, "cpu", seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for bn in bns:
        bn.momentum = None  # the running statistics become the batch's
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(np.random.default_rng(seed).uniform(
            -1, 1, calib_shape).astype(np.float32)))
    model.eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in bns:
            bn.weight.add_(torch.from_numpy(0.1 * rng.normal(size=bn.weight.shape)).float())
            bn.bias.add_(torch.from_numpy(0.1 * rng.normal(size=bn.bias.shape)).float())
    sd = model.state_dict()
    return sd, {k: v.numpy() for k, v in sd.items()}


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def i3d_weights():
    """Port state dicts of both I3D variants and their JAX trees."""
    out = {}
    for backend, classes, seed, calib in (("videogpt", None, 1, (2, 3, 10, 32, 32)),
                                          ("styleganv", 400, 2, (1, 3, 9, 193, 193))):
        sd, numpy_sd = _live_backbone(lambda c=classes: InceptionI3D(c), seed, calib)
        out[backend] = sd, jax_fvd.load_i3d_torch_weights(numpy_sd)
    return out


def test_inception_matches_jax():
    sd, numpy_sd = _live_backbone(InceptionV3FID, 0, (2, 3, 75, 75))
    tree = jax_fid.load_inception_torch_weights(numpy_sd)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = jax.jit(jax_fid.InceptionV3FID().apply)(tree, x)
    model = backbone(InceptionV3FID, sd, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048) and _rel_err(got, want) <= FEAT_TOL


@pytest.mark.parametrize("backend,shape", [("videogpt", (2, 10, 32, 32)),
                                           ("styleganv", (1, 9, 193, 193))])
def test_i3d_heads_match_jax(i3d_weights, backend, shape):
    """The mean-pool head, and the logits head at its smallest input."""
    sd, tree = i3d_weights[backend]
    classes = 400 if backend == "styleganv" else None
    x = np.random.default_rng(1).uniform(-1, 1, (*shape, 3)).astype(np.float32)
    want = jax.jit(jax_fvd.InceptionI3D(num_classes=classes).apply)(tree, x)
    model = backbone(lambda: InceptionI3D(classes), sd, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    assert got.shape == (shape[0], classes or 1024) and _rel_err(got, want) <= FEAT_TOL


def _jax_i3d_inputs(v, resize, backend):
    """hma_tpu's make_i3d_embed_fn preprocessing (metrics/fvd.py:161-176)."""
    N, T, H, W = v.shape[:4]
    v = jnp.asarray(v, jnp.float32)
    th = tw = resize
    if backend == "styleganv":
        scale = resize / min(H, W)
        th, tw = (resize, math.ceil(W * scale)) if H < W else (math.ceil(H * scale), resize)
    v = jax.image.resize(v, (N, T, th, tw, 3), "bilinear")
    h0, w0 = (th - resize) // 2, (tw - resize) // 2
    return np.asarray(v[:, :, h0:h0 + resize, w0:w0 + resize] / 127.5 - 1.0)


@pytest.mark.parametrize("backend,shape", [
    ("inception", (2, 64, 48)),          # up to 299²
    ("inception", (1, 320, 310)),        # down to 299², antialiased
    ("videogpt", (1, 2, 256, 256)),      # down to 224²
    ("styleganv", (1, 2, 64, 96)),       # shorter side up to 224, 336 cropped
    ("styleganv", (1, 2, 300, 260))])    # shorter side down to 224, 259 cropped
def test_resize_and_crop_match_jax(backend, shape):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    if backend == "inception":  # hma_tpu/metrics/fid.py:222-224
        want = np.asarray(jax.image.resize(jnp.asarray(frames, jnp.float32),
                                           (shape[0], 299, 299, 3), "bilinear") / 127.5 - 1.0)
        got = inception_inputs(torch.from_numpy(frames)).permute(0, 2, 3, 1).numpy()
    else:
        want = _jax_i3d_inputs(frames, 224, backend)
        got = i3d_inputs(torch.from_numpy(frames), 224, backend).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_TOL)


def test_i3d_embed_fn_matches_jax(i3d_weights):
    """videogpt at resize 32, two clips in batches of one, 48x40 shrunk. A
    file with the logits head loads under videogpt (the head left out); one
    that lacks a key of the net raises."""
    sd, tree = i3d_weights["videogpt"]
    videos = np.random.default_rng(3).integers(0, 256, (2, 10, 48, 40, 3)).astype(np.uint8)
    got = make_i3d_embed_fn(sd, batch_size=1, resize=32, device="cpu")(videos)
    want = jax_fvd.make_i3d_embed_fn(params=tree, batch_size=1, resize=32)(videos)
    assert got.shape == want.shape == (2, 1024) and _rel_err(got, want) <= FEAT_TOL
    head = {k: v for k, v in i3d_weights["styleganv"][0].items() if k.startswith("logits.")}
    np.testing.assert_array_equal(
        make_i3d_embed_fn({**sd, **head}, batch_size=1, resize=32, device="cpu")(videos), got)
    with pytest.raises(KeyError, match="lack 1 keys"):
        make_i3d_embed_fn({k: v for k, v in sd.items() if k != "Mixed_5c.b0.conv3d.weight"},
                          device="cpu")


def test_calculate_fvd_matches_jax(i3d_weights):
    """The reference default, styleganv at 224: 64x96 clips go up to 224x336
    and are cropped, through the logits head (its features on their own
    are held above at 193²)."""
    sd, tree = i3d_weights["styleganv"]
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 256, (2, 10, 64, 96, 3)).astype(np.uint8)
    gt = np.clip(pred.astype(int) + rng.integers(-60, 60, pred.shape), 0, 255).astype(np.uint8)
    got = calculate_fvd(pred, gt, backend="styleganv", i3d_state_dict=sd, device="cpu")
    want = jax_fvd.calculate_fvd(pred, gt, backend="styleganv", i3d_params=tree)
    assert got > 0 and got == pytest.approx(want, rel=FVD_RTOL)
    with pytest.raises(ValueError, match=">= 10 frames"):
        calculate_fvd(pred[:, :9], gt[:, :9], device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_i3d_embed_fn(backend="i3d", device="cpu")


def test_evaluate_feature_pixel_fid(tmp_path, monkeypatch):
    """`--vae_checkpoint --compute_fid` on the tiny STMAR card (4x4x4
    latents, decoded to 32² frames by a default-width VAE written here): the
    fid the CLI reports is calculate_fid's on the clips that decode_clips
    makes of the port's own predictions (seed FID_SEED) and of the ground
    truth, and hma_tpu's calculate_fid on the same clips with the same
    (seeded) Inception weights converted."""
    card = tiny_mar_card()
    rng = np.random.default_rng(5)
    write_token_dataset(tmp_path / "data", rng.normal(size=(10, 4, 4, 4)).astype(np.float16),
                        np.zeros(10, np.int32), rng.normal(size=(10, 4)).astype(np.float32),
                        {"name": "a", "latent_channels": 4})
    cfg = DiffusionGenieConfig(**card)
    model = STMAR(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), "ckpt", model.state_dict(), cfg)
    vae = SVDTemporalVAE(dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(6))
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    seen = []

    def recording_fid(pred_px, gt_px, **kw):
        seen.append((pred_px, gt_px))
        return calculate_fid(pred_px, gt_px, **kw)

    monkeypatch.setattr(port_evaluate_feature, "calculate_fid", recording_fid)
    got = port_evaluate_feature.main([
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--val_data_dir", str(tmp_path / "data"),
        "--output_dir", str(tmp_path / "out"), "--batch_size", "1", "--max_examples", "1",
        "--vae_checkpoint", str(tmp_path / "vae.pt"), "--compute_fid", "--device", "cpu"])
    assert {"fid", "fid_latent"} <= set(got) and "fvd" not in got  # T 4 < 10
    [(pred_px, gt_px)] = seen

    model, config = load_mar_model(str(tmp_path / "ckpt"), "cpu", torch.float32)
    item = RawFeatureDataset(tmp_path / "data", window_size=4, use_actions=True)[0]
    lat = torch.from_numpy(item["input_ids"].reshape(1, 4, 4, 4, 4).astype(np.float32))
    acts = torch.from_numpy(np.pad(item["action_ids"].astype(np.float32)[None],
                                   ((0, 0), (0, 0), (0, config.max_d_action - 4))))
    with torch.no_grad():
        pred = torch.cat([lat[:, :1], teacher_forced_latents(
            model, lat, acts, 0, torch.Generator().manual_seed(FID_SEED))], 1)
    decode = load_svd_decoder(str(tmp_path / "vae.pt"), device="cpu")
    want_pred, want_gt = decode_clips(decode, pred.numpy()), decode_clips(decode, lat.numpy())
    assert want_pred.shape == (1, 4, 32, 32, 3) and want_pred.dtype == np.uint8
    np.testing.assert_array_equal(pred_px, want_pred.reshape(4, 32, 32, 3))
    np.testing.assert_array_equal(gt_px, want_gt.reshape(4, 32, 32, 3))

    inception = backbone(InceptionV3FID, None, "cpu", seed=0).state_dict()
    tree = jax_fid.load_inception_torch_weights({k: v.numpy() for k, v in inception.items()})
    want = jax_fid.calculate_fid(pred_px, gt_px, embed_fn=jax_fid.make_inception_embed_fn(tree))
    assert got["fid"] > 0 and got["fid"] == pytest.approx(want, rel=FID_RTOL)
