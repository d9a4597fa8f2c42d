"""The port's interactive simulator against hma_tpu's, on the CPU in fp32:
GenieSimulator over the tiny discrete card gives hma_tpu's tokens and
rolled caches step for step (at 1 MaskGIT step, and at 2 with JAX's unmask
draws handed in), over the tiny STMAR card hma_tpu's latents with JAX's
draws; the physics comparison's PSNR equals hma_tpu's, a failing decoder
fails the step, the driver saves its frames, `build_simulator` loads
both families, and the pixel entry points raise without a card. A pixel
prompt through a small codec's `encode_image` gives hma_tpu's prompt tokens
and greedy next frame."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hma_tpu.data.encode_openx import make_magvit_encoder as jax_make_magvit_encoder
from hma_tpu.data.extern.toyworld import toyworld_episode_generator
from hma_tpu.sim.simulator import GenieSimulator as JaxGenieSimulator
from hma_tpu.sim.simulator import ReplaySimulator as JaxReplaySimulator
from hma_tpu.tokenizer.convert import torch_state_dict_to_flax
from hma_tpu.tokenizer.magvit2 import VQConfig as JaxVQConfig
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.data.encode_openx import make_magvit_encoder
from hma_tpu_torch.sim.app import DIRECTION_ACTIONS, build_simulator
from hma_tpu_torch.sim.main import InteractiveDigitalWorld
from hma_tpu_torch.sim.simulator import GenieSimulator, PhysicsSimulator, ReplaySimulator
from hma_tpu_torch.sim.viewer import Viewer
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from torch_port_helpers import (
    build_mar_pair,
    build_pair,
    jax_horizon_draws,
    jax_mar_frame_draws,
    tiny_card,
    tiny_mar_card,
)

STEPS = 3
H = 3  # prompt horizon


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, _, _ = build_pair(B=1)
    return jm, params, tm.eval()


def _prompt(cfg, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, cfg.image_vocab_size, (H, cfg.h, cfg.w)).astype(np.int32)
    actions = rng.normal(size=(H, cfg.max_d_action)).astype(np.float32)
    moves = rng.normal(size=(STEPS, cfg.d_actions[0])).astype(np.float32)
    return frames, actions, moves


@pytest.mark.parametrize("maskgit_steps", [1, 2])
def test_discrete_sim_matches_jax(pair, maskgit_steps):
    jm, params, tm = pair
    cfg = jm.config
    frames, actions, moves = _prompt(cfg, 1)
    jsim = JaxGenieSimulator(jm, params, prompt_horizon=H, maskgit_steps=maskgit_steps)
    sim = GenieSimulator(tm, prompt_horizon=H, maskgit_steps=maskgit_steps)
    for s in (jsim, sim):
        s.set_initial_state(frames, actions)
    np.testing.assert_array_equal(sim.reset(), frames[-1])
    key = jax.random.PRNGKey(0)  # the JAX simulator's key, split a step
    for move in moves:
        key, k = jax.random.split(key)
        draws = (None if maskgit_steps == 1 else
                 torch.from_numpy(jax_horizon_draws(k, maskgit_steps, 1, cfg.S)))
        want = jsim.step(move)
        got = sim.step(move, draws=draws)
        assert got.dtype == np.int32 and got.shape == (cfg.h, cfg.w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(sim._token_cache, jsim._token_cache)
        np.testing.assert_array_equal(sim._action_cache, np.asarray(jsim._action_cache))
    stats = sim.measure_step_time()
    assert set(stats) == set(jsim.measure_step_time()) and stats["n"] == STEPS


def test_stmar_sim_matches_jax():
    jm, params, tm, lat, actions = build_mar_pair(B=1)
    cfg = jm.config
    jsim = JaxGenieSimulator(jm, params, prompt_horizon=H, maskgit_steps=2, temperature=1.0)
    sim = GenieSimulator(tm.eval(), prompt_horizon=H, maskgit_steps=2, temperature=1.0)
    for s in (jsim, sim):
        s.set_initial_state(lat[0, :H], actions[0, :H])
    S_p = cfg.S // cfg.patch_size**2
    K = int(cfg.num_sampling_steps)
    C = cfg.vae_embed_dim * cfg.patch_size**2
    key = jax.random.PRNGKey(0)
    for move in np.random.default_rng(2).normal(size=(STEPS, 4)).astype(np.float32):
        key, k = jax.random.split(key)
        want = jsim.step(move)
        got = sim.step(move, draws=jax_mar_frame_draws(k, 1, S_p, 2, K, C))
        assert got.shape == (cfg.h, cfg.h, cfg.vae_embed_dim) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sim._token_cache, jsim._token_cache, rtol=1e-5, atol=1e-5)


def test_pixel_prompt_matches_jax(pair):
    """Three 8² toyworld frames through the small codec (4² tokens, the tiny
    card's grid), encoded by each package's encoder one frame at a time."""
    jm, params, tm = pair
    small = dict(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    codec = VQModel(VQConfig(**small), dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(9)).eval()
    jax_params = torch_state_dict_to_flax({k: v.numpy() for k, v in codec.state_dict().items()})
    enc = make_magvit_encoder(codec, batch_size=1)
    jax_enc = jax_make_magvit_encoder(jax_params, JaxVQConfig(**small), batch_size=1,
                                      dtype=jnp.float32)
    ep = next(toyworld_episode_generator(0, 1, image_size=8, episode_len=H + 2))
    pixels = np.stack([s["image"] for s in ep["steps"]])
    jsim = JaxGenieSimulator(jm, params, prompt_horizon=H, maskgit_steps=1,
                             encode_image=lambda f: jax_enc(f[None])[0])
    sim = GenieSimulator(tm, prompt_horizon=H, maskgit_steps=1,
                         encode_image=lambda f: enc(f[None])[0])
    for s in (jsim, sim):
        s.set_initial_state(pixels[:H])
    assert sim._token_cache.shape == (H, 4, 4) and sim._token_cache.dtype == np.int32
    np.testing.assert_array_equal(sim._token_cache, jsim._token_cache)
    np.testing.assert_array_equal(sim._token_cache, enc(pixels[:H]).astype(np.int32))
    move = np.asarray([0.5, -0.25, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(sim.step(move), jsim.step(move))
    with pytest.raises(ValueError, match="encode_image"):
        GenieSimulator(tm, prompt_horizon=H).set_initial_state(pixels[:H])


def _fake_decode_tokens(tokens):
    """(N, h, w) ints -> (N, h, w, 3) uint8 pseudo-pixels."""
    t = np.asarray(tokens) % 251
    return np.stack([t, (t * 3) % 256, (t * 7) % 256], axis=-1).astype(np.uint8)


def test_physics_psnr_matches_jax_and_delta_psnr(pair):
    jm, params, tm = pair
    cfg = jm.config
    frames, actions, moves = _prompt(cfg, 3)
    gt = _fake_decode_tokens(np.zeros((1, cfg.h, cfg.w), np.int32))[0]
    jsim = JaxGenieSimulator(jm, params, prompt_horizon=H, maskgit_steps=1,
                             decode_tokens=_fake_decode_tokens,
                             physics_simulator=JaxReplaySimulator(np.stack([gt] * 9)))
    sim = GenieSimulator(tm, prompt_horizon=H, maskgit_steps=1,
                         decode_tokens=_fake_decode_tokens,
                         physics_simulator=ReplaySimulator(np.stack([gt] * 9)),
                         compute_delta_psnr=True)
    sim.average_delta_psnr_over = 2
    for s in (jsim, sim):
        s.set_initial_state(frames, actions)
    for move in moves[:2]:
        np.testing.assert_array_equal(sim.step(move), jsim.step(move))
    stats, want = sim.measure_step_time(), jsim.measure_step_time()
    np.testing.assert_allclose(stats["psnr_vs_physics"], want["psnr_vs_physics"], rtol=1e-6)
    assert np.isfinite(stats["delta_psnr"]) and len(sim._delta_psnr_history) == 2


def test_step_errors_propagate(pair):
    _, _, tm = pair
    cfg = tm.config

    def broken_decoder(tokens):
        raise RuntimeError("decoder fault")

    sim = GenieSimulator(tm, prompt_horizon=H, maskgit_steps=1, decode_tokens=broken_decoder)
    with pytest.raises(RuntimeError, match="set_initial_state"):
        sim.step(np.zeros(2))
    sim.set_initial_state(_prompt(cfg, 4)[0])
    with pytest.raises(RuntimeError, match="decoder fault"):
        sim.step(np.zeros(2))
    with pytest.raises(ValueError, match="frames"):
        sim.set_initial_state(np.zeros((H + 1, cfg.h, cfg.w), np.int32))
    with pytest.raises(ValueError, match="prompt_horizon"):
        GenieSimulator(tm, prompt_horizon=cfg.T)
    with pytest.raises(ValueError, match="physics"):
        GenieSimulator(tm, compute_delta_psnr=True)


def test_driver_saves_frames_and_physics_adapter(pair, tmp_path, monkeypatch):
    _, _, tm = pair
    cfg = tm.config
    sim = GenieSimulator(tm, prompt_horizon=H, maskgit_steps=1,
                         decode_tokens=_fake_decode_tokens)
    sim.set_initial_state(_prompt(cfg, 5)[0])
    world = InteractiveDigitalWorld(sim, policy=lambda obs: DIRECTION_ACTIONS["up"],
                                    save_dir=str(tmp_path / "vid"))
    stats = world.run(STEPS)
    assert stats["n"] == STEPS and stats["p50_ms"] > 0
    saved = np.load(tmp_path / "vid" / "frames.npy")
    assert saved.shape == (STEPS + 1, cfg.h, cfg.w, 3) and saved.dtype == np.uint8
    assert (tmp_path / "vid" / "rollout.gif").is_file()

    class Env:
        def step(self, action):
            return [float(np.sum(action))]

        def reset(self):
            return "start"

    phys = PhysicsSimulator(Env())
    assert phys.reset() == "start" and phys.step(np.ones(3)).tolist() == [3.0]
    replay = ReplaySimulator(np.arange(3))
    assert (replay.step(), replay.step(), replay.step(), replay.step()) == (0, 1, 2, 2)
    assert replay.reset() == 0
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    viewer = Viewer().start()  # headless: it shows nothing and stops
    viewer.push(np.zeros((4, 4, 3), np.uint8))
    viewer.close()
    assert not viewer._thread.is_alive() and not viewer._ok


def test_build_simulator_loads_both_families(tmp_path):
    card = tiny_card()
    cfg = GenieConfig(**card)
    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    model = STMaskGIT(cfg, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), "ckpt", model.state_dict(), cfg)
    vq_cfg = VQConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    vq = VQModel(vq_cfg, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    torch.save({"state_dict": vq.state_dict()}, tmp_path / "tok.ckpt")
    vq_cfg.save_pretrained(str(tmp_path / "tok.ckpt.json"))
    sim = build_simulator(str(tmp_path / "ckpt"), str(tmp_path / "tok.ckpt"), domain="a",
                          device="cpu")
    assert sim.backbone == "stmaskgit"
    sim.set_initial_state(_prompt(cfg, 6)[0])
    frame = sim.step(DIRECTION_ACTIONS["left"])
    assert frame.shape == (2 * cfg.h, 2 * cfg.w, 3) and frame.dtype == np.uint8

    mcfg = DiffusionGenieConfig(**tiny_mar_card())
    from hma_tpu_torch.models.st_mar import STMAR

    mar = STMAR(mcfg, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(2))
    save_checkpoint(str(tmp_path), "mar", mar.state_dict(), mcfg)
    with pytest.raises(FileNotFoundError, match="vae.pt"):  # the SVD-VAE's file
        build_simulator(str(tmp_path / "mar"), str(tmp_path / "vae.pt"), device="cpu")
    sim = build_simulator(str(tmp_path / "mar"), None, device="cpu")
    assert sim.backbone == "stmar" and sim._decode is None
    sim.set_initial_state(np.zeros((H, mcfg.h, mcfg.h, mcfg.vae_embed_dim), np.float32))
    assert sim.step(np.zeros(4)).shape == (mcfg.h, mcfg.h, mcfg.vae_embed_dim)


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    """`build_simulator`, `make_token_decoder`, `make_magvit_encoder` and
    `load_svd_decoder` run on the card unless given a device: without one
    they raise, they do not carry on on the CPU."""
    from hma_tpu_torch.data.encode_openx import make_magvit_encoder
    from hma_tpu_torch.rollout.decode import load_svd_decoder, make_token_decoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vq_cfg = VQConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    state = VQModel(vq_cfg, dtype=torch.float32, device="cpu").state_dict()
    for make in (make_token_decoder, make_magvit_encoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(state, vq_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_simulator(str(tmp_path / "ckpt"), str(tmp_path / "tok.ckpt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_svd_decoder(str(tmp_path / "vae.pt"))
