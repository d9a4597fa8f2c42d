"""The port's evaluation metrics against hma_tpu's on the same numpy inputs:
token loss to 1e-5 relative and accuracy equal, PSNR and SSIM to 1e-5
relative, the Fréchet distances of FID and FVD to 1e-6 relative (the
exact low-rank form too, where both sets have fewer samples than
dimensions); without an
embed_fn and without a card, FID and FVD raise (their backbones run on the
card; tests/test_torch_fid_fvd.py holds them to hma_tpu's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.metrics import fid as jax_fid
from hma_tpu.metrics import fvd as jax_fvd
from hma_tpu.metrics import image as jax_image
from hma_tpu.metrics import token as jax_token
from hma_tpu_torch.metrics import fid, fvd, image, token


@pytest.mark.parametrize("nv,fv", [(2, 16), (1, 64)])
def test_teacher_forced_metrics_match_jax(nv, fv):
    rng = np.random.default_rng(nv)
    logits = (3 * rng.normal(size=(2, 3, 16, nv, fv))).astype(np.float32)
    targets = rng.integers(0, fv**nv, (2, 3, 16))
    # half the tokens right on every factor, so that acc is neither 0 nor 1
    argmax = (logits.argmax(-1) * fv ** np.arange(nv)).sum(-1)
    targets[..., ::2] = argmax[..., ::2]
    want = jax_token.teacher_forced_metrics(jnp.asarray(logits),
                                            jnp.asarray(targets, jnp.int32), fv)
    got = token.teacher_forced_metrics(torch.from_numpy(logits),
                                       torch.from_numpy(targets), fv)
    for k in ("loss", "perplexity"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    # the same tokens right (the fp32 means may differ in their last bit)
    n = targets.size
    assert round(float(got["acc"]) * n) == round(float(want["acc"]) * n)
    assert 0 < round(float(got["acc"]) * n) < n


def test_avg_metric_weights_by_count():
    m = token.AvgMetric()
    m.update(1.0, 3)
    m.update(5.0, 1)
    assert m.mean() == 2.0 and m.count == 4
    assert token.AvgMetric().mean() == 0.0


def _images(seed, shape=(3, 20, 24, 3)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    noise = rng.integers(-30, 31, shape)
    return a, np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def test_psnr_and_ssim_match_jax():
    pred, gt = _images(0)
    np.testing.assert_allclose(float(image.psnr(pred, gt)),
                               float(jax_image.psnr(pred, gt)), rtol=1e-5)
    np.testing.assert_allclose(float(image.ssim(pred[0], gt[0])),
                               float(jax_image.ssim(pred[0], gt[0])), rtol=1e-5)
    np.testing.assert_allclose(image.batch_psnr(pred, gt),
                               jax_image.batch_psnr(pred, gt), rtol=1e-5)
    np.testing.assert_allclose(image.batch_ssim(pred, gt),
                               jax_image.batch_ssim(pred, gt), rtol=1e-5)
    assert float(image.ssim(pred[0], pred[0])) == pytest.approx(1.0, abs=1e-6)
    assert image.delta_psnr(30.0, [20.0, 24.0]) == jax_image.delta_psnr(30.0, [20.0, 24.0])


def test_frechet_distances_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 6))
    b = 0.5 + 1.3 * rng.normal(size=(40, 6))
    np.testing.assert_allclose(fid.fid_from_features(a, b),
                               jax_fid.fid_from_features(a, b), rtol=1e-6)
    stats = fid.activation_statistics(a) + fid.activation_statistics(b)
    np.testing.assert_allclose(fid.frechet_distance(*stats),
                               jax_fid.frechet_distance(*stats), rtol=1e-6)
    embed = lambda v: v.reshape(len(v), -1)[:, ::7].astype(np.float32)
    va, vb = rng.normal(size=(12, 10, 2, 2, 1)), rng.normal(size=(12, 10, 2, 2, 1)) + 0.3
    np.testing.assert_allclose(fvd.calculate_fvd(va, vb, embed),
                               jax_fvd.calculate_fvd(va, vb, embed_fn=embed), rtol=1e-6)
    np.testing.assert_allclose(fid.calculate_fid(a, b, embed_fn=lambda x: x),
                               jax_fid.calculate_fid(a, b, embed_fn=lambda x: x), rtol=1e-6)


@pytest.mark.parametrize("n,m,dim", [(8, 8, 256), (12, 5, 300), (299, 7, 300)])
def test_low_rank_frechet_distance_matches_jax(n, m, dim):
    """Fewer samples than dimensions on both sides: the exact low-rank form
    against hma_tpu's scipy sqrtm of the singular covariances (and the last
    case, n >= dim, through sqrtm on both sides)."""
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=(n, dim)), 0.3 + 1.2 * rng.normal(size=(m, dim))
    np.testing.assert_allclose(fid.fid_from_features(a, b),
                               jax_fid.fid_from_features(a, b), rtol=1e-6)


def test_backbones_that_are_not_ported_raise(monkeypatch):
    """Without an embed_fn the metrics build their backbone on the card: with
    no card and no device they raise rather than carry on on the CPU. FVD
    refuses clips of fewer than 10 frames before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.calculate_fid(np.zeros((2, 8, 8, 3), np.uint8), np.zeros((2, 8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fvd.calculate_fvd(np.zeros((2, 10, 8, 8, 3), np.uint8),
                          np.zeros((2, 10, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match=">= 10 frames"):
        fvd.calculate_fvd(np.zeros((2, 9, 4)), np.zeros((2, 9, 4)), lambda v: v)
