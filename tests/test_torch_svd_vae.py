"""The port's SVD temporal VAE against hma_tpu's, on the CPU in fp32: the
encoder and the temporal decoder at block_out (32, 32) through hma_tpu's own
importer (`load_svd_vae_torch_weights(strict=True)`) to 1e-4 of max|x|; the
released architecture's state dict in the diffusers key layout (meta
tensors, no conv runs); `load_svd_decoder` on a default-width state-dict file
written here against hma_tpu's on the same file; and `build_simulator` on the
tiny STMAR card with that file, pixel frames against hma_tpu's simulator at
temperature 0 with JAX's draws handed in. No flax `init` runs: the JAX trees
come from the port's state dicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.rollout import decode as jax_decode
from hma_tpu.sim.app import _make_latent_decoder as jax_make_latent_decoder
from hma_tpu.sim.simulator import GenieSimulator as JaxGenieSimulator
from hma_tpu.tokenizer.svd_vae import SVDTemporalVAE as JaxSVDTemporalVAE
from hma_tpu.tokenizer.svd_vae import load_svd_vae_torch_weights
from hma_tpu_torch.rollout.decode import load_svd_decoder
from hma_tpu_torch.sim.app import build_simulator
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from test_svd_vae import _diffusers_svd_vae_key_manifest
from torch_port_helpers import build_mar_pair, jax_mar_frame_draws

SMALL = (32, 32)  # block_out of tests/test_svd_vae.py's parity test
TOL = 1e-4  # of max|x| (latents, frames), fp32 on both sides; reads ~1e-6


def _port_vae(block_out, seed, all_tensors=True):
    """The port's VAE in fp32 on the CPU from `seed`, plus noise: on every
    tensor, or (default width, where the convs are random already) on the
    GroupNorm scales, the zero biases and mix_factor only."""
    vae = SVDTemporalVAE(block_out, dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    vae.load_state_dict({k: v + torch.from_numpy(0.05 * rng.normal(size=v.shape)).float()
                         if all_tensors or v.dim() == 1 else v
                         for k, v in vae.state_dict().items()})
    return vae.eval()


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_encoder_and_temporal_decoder_match_jax():
    vae = _port_vae(SMALL, 0)
    tree = load_svd_vae_torch_weights(vae.state_dict(), block_out=SMALL, strict=True)
    jm = JaxSVDTemporalVAE(block_out=SMALL)
    rng = np.random.default_rng(1)
    frames = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    z = 3 * rng.normal(size=(1, 3, 8, 8, 4)).astype(np.float32)  # B 1, T 3
    want_z = jax.jit(lambda p, x: jm.apply(p, x, method=JaxSVDTemporalVAE.encode))(tree, frames)
    want_x = jax.jit(lambda p, x: jm.apply(p, x, method=JaxSVDTemporalVAE.decode))(tree, z)
    with torch.no_grad():
        got_z = vae.encode(torch.from_numpy(frames)).numpy()
        got_x = vae.decode(torch.from_numpy(z)).numpy()
    assert got_z.shape == (3, 8, 8, 4) and got_x.shape == (1, 3, 16, 16, 3)
    assert _rel_err(got_z, want_z) <= TOL
    assert _rel_err(got_x, want_x) <= TOL
    # the temporal convs are live: a clip's frames are not decoded alone
    with torch.no_grad():
        alone = vae.decode(torch.from_numpy(z[:, :1])).numpy()
    assert _rel_err(alone[:, 0], got_x[:, 0]) > 100 * TOL


def test_default_width_is_the_diffusers_key_layout():
    """Every key of the released architecture's state dict, at its shape,
    goes through hma_tpu's importer (strict) onto the JAX model's parameter
    tree, and equals the hand-derived diffusers manifest."""
    sd = SVDTemporalVAE(dtype=torch.float32, device="meta").state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert shapes == _diffusers_svd_vae_key_manifest((128, 256, 512, 512))
    zero = np.zeros((), np.float32)
    params = load_svd_vae_torch_weights(
        {k: np.broadcast_to(zero, s) for k, s in shapes.items()}, strict=True)
    want = jax.eval_shape(JaxSVDTemporalVAE().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3), jnp.float32))
    assert (jax.tree.map(lambda a: tuple(a.shape), params)
            == jax.tree.map(lambda a: tuple(a.shape), want))
    assert sum(v.numel() for v in sd.values()) == 97_742_847


@pytest.fixture(scope="module")
def vae_file(tmp_path_factory):
    """A default-width state-dict file of the port's VAE, and hma_tpu's
    decoder loaded from it (one JAX load for the module)."""
    path = tmp_path_factory.mktemp("svd_vae") / "vae.pt"
    torch.save(_port_vae((128, 256, 512, 512), 2, all_tensors=False).state_dict(), path)
    return path, jax_decode.load_svd_decoder(str(path))


def test_load_svd_decoder_matches_jax(vae_file):
    """At the simulator's shape (one 4² frame), so that the two tests share
    one JAX compile; the temporal convs over T 3 are held at block_out
    (32, 32) above."""
    path, jax_decoder = vae_file
    decode = load_svd_decoder(str(path), device="cpu")
    z = 3 * np.random.default_rng(3).normal(size=(1, 1, 4, 4, 4)).astype(np.float32)
    got = decode(z)
    assert got.dtype == np.float32 and got.shape == (1, 1, 32, 32, 3)
    assert _rel_err(got, jax_decoder(z)) <= TOL
    np.testing.assert_array_equal(decode(torch.from_numpy(z)), got)


def test_stmar_simulator_pixels_match_jax(vae_file, tmp_path, monkeypatch):
    path, jax_decoder = vae_file
    jm, params, tm, lat, actions = build_mar_pair(B=1)
    cfg = tm.config
    save_checkpoint(str(tmp_path), "mar", tm.state_dict(), cfg)
    sim = build_simulator(str(tmp_path / "mar"), str(path), device="cpu")
    assert sim.backbone == "stmar" and (sim.maskgit_steps, sim.temperature) == (2, 0.0)
    monkeypatch.setattr(jax_decode, "load_svd_decoder", lambda _: jax_decoder)
    jsim = JaxGenieSimulator(jm, params, prompt_horizon=3, maskgit_steps=2, temperature=0.0,
                             decode_latents=jax_make_latent_decoder(str(path)))
    for s in (jsim, sim):
        s.set_initial_state(lat[0, :3], actions[0, :3])
    S_p, C = cfg.S // cfg.patch_size**2, cfg.vae_embed_dim * cfg.patch_size**2
    key = jax.random.PRNGKey(0)  # the JAX simulator's key, split a step
    for move in np.random.default_rng(4).normal(size=(2, 4)).astype(np.float32):
        key, k = jax.random.split(key)
        want = jsim.step(move)
        got = sim.step(move, draws=jax_mar_frame_draws(k, 1, S_p, 2,
                                                       int(cfg.num_sampling_steps), C))
        assert got.shape == (8 * cfg.h, 8 * cfg.h, 3) and got.dtype == np.uint8
        np.testing.assert_allclose(sim._token_cache, jsim._token_cache, rtol=1e-5, atol=1e-5)
        # frames within TOL of each other: a uint8 level apart at most where
        # a value lies at a rounding edge
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
