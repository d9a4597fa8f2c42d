"""Interactive learned world-model simulators (counterpart of
hma_tpu/sim/simulator.py).

`GenieSimulator` holds rolling caches of the last `prompt_horizon` frames
(tokens or latents) and actions; `step(action)` builds a fresh temporal KV
cache from that window, decodes the next frame with the cached MaskGIT
(STMaskGIT) or MAR (STMAR) step, decodes it to pixels when given a decoder,
and rolls the caches. `PhysicsSimulator` and `ReplaySimulator` are
ground-truth sources it can be compared with (PSNR and the ΔPSNR
controllability probe). Random draws come from the simulator's own
`torch.Generator` and numpy Generator, both seeded from `seed`; `step`
also takes a frame's draws as tensors (`rollout.maskgit` / `rollout.mar`
formats), so that a test can hand in `hma_tpu`'s.
"""

from __future__ import annotations

import abc
import time
from typing import Callable, Optional

import numpy as np
import torch

from hma_tpu_torch.metrics.image import psnr
from hma_tpu_torch.models.st_mar import STMAR, patchify, unpatchify
from hma_tpu_torch.rollout.mar import generate_frame_mar
from hma_tpu_torch.rollout.maskgit import _prefill, generate_frame


class Simulator(abc.ABC):
    @abc.abstractmethod
    def step(self, action: np.ndarray) -> np.ndarray:
        ...

    @abc.abstractmethod
    def reset(self):
        ...


class PhysicsSimulator(Simulator):
    """Adapter around a ground-truth physics env (e.g. robosuite/MuJoCo),
    for side-by-side comparison."""

    def __init__(self, env):
        self.env = env

    def step(self, action):
        return np.asarray(self.env.step(action))

    def reset(self):
        return self.env.reset()


class ReplaySimulator(Simulator):
    """Replays a prerecorded frame sequence, ignoring actions."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.idx = 0

    def step(self, action=None):
        frame = self.frames[min(self.idx, len(self.frames) - 1)]
        self.idx += 1
        return frame

    def reset(self):
        self.idx = 0
        return self.frames[0]


class LearnedSimulator(Simulator, abc.ABC):
    """Marker base for model-backed simulators."""


class GenieSimulator(LearnedSimulator):
    """Action-controllable interactive world model over an `STMaskGIT`
    (discrete tokens, a rolling (H, h, w) int cache) or an `STMAR`
    (continuous latents, a rolling (H, h, w, C) float cache), on the model's
    device.

    Args:
        model: the world model, in eval mode.
        decode_tokens: discrete: (N, h, w) ints -> (N, H, W, 3) uint8.
        decode_latents: continuous: (N, h, w, C) latents -> (N, H, W, 3) uint8.
        encode_image: (H, W, 3) uint8 -> (h, w) tokens / (h, w, C) latents,
            for pixel prompts (e.g. a `data.encode_openx` encoder of one frame).
        prompt_horizon: context frames kept in the rolling cache.
        physics_simulator: optional ground truth for PSNR comparison.
        compute_delta_psnr: per-step ΔPSNR, PSNR(gt, pred) less the mean
            over `average_delta_psnr_over` rollouts with N(0, 1) actions.
    """

    average_delta_psnr_over = 5

    def __init__(self, model, *, domain_id: int = 0, prompt_horizon: int = 3,
                 maskgit_steps: int = 2, temperature: float = 0.0,
                 decode_tokens: Optional[Callable] = None,
                 decode_latents: Optional[Callable] = None,
                 encode_image: Optional[Callable] = None,
                 physics_simulator: Optional[Simulator] = None,
                 compute_delta_psnr: bool = False, seed: int = 0):
        cfg = model.config
        if prompt_horizon >= cfg.T:
            raise ValueError(f"prompt_horizon {prompt_horizon} must be below the "
                             f"trained window T={cfg.T}")
        self.backbone = "stmar" if isinstance(model, STMAR) else "stmaskgit"
        self.model = model
        self.config = cfg
        self.device = next(model.parameters()).device
        self.domain_id = domain_id
        self.prompt_horizon = prompt_horizon
        self.maskgit_steps = maskgit_steps
        self.temperature = temperature
        self._decode = decode_latents if self.backbone == "stmar" else decode_tokens
        self.encode_image = encode_image
        self.physics = physics_simulator
        self.compute_delta_psnr = compute_delta_psnr
        if compute_delta_psnr and (physics_simulator is None or self._decode is None):
            raise ValueError("delta-PSNR needs a physics simulator and a pixel decoder")
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._rng = np.random.default_rng(seed)
        self._step_times: list[float] = []
        self._psnr_history: list[float] = []
        self._delta_psnr_history: list[float] = []
        # rolling state: (H, h, w) int32 tokens or (H, h, w, C) float32 latents
        self._token_cache: Optional[np.ndarray] = None
        self._action_cache: Optional[np.ndarray] = None  # (H, max_da)

    # ------------------------------------------------------------------

    def set_initial_state(self, frames, actions=None) -> None:
        """frames: (prompt_horizon, h, w) token grids (discrete),
        (prompt_horizon, h, w, C) latents (continuous), or (prompt_horizon, H,
        W, 3) uint8 images, each encoded by `encode_image`."""
        frames = np.asarray(frames)
        if frames.ndim == 4 and frames.dtype == np.uint8:
            if self.encode_image is None:
                raise ValueError("pixel prompts need encode_image")
            frames = np.stack([np.asarray(self.encode_image(f)) for f in frames])
        want_ndim = 3 if self.backbone == "stmaskgit" else 4
        if frames.shape[0] != self.prompt_horizon or frames.ndim != want_ndim:
            raise ValueError(f"{self.prompt_horizon} frames of {want_ndim - 1} dims "
                             f"expected, got {frames.shape}")
        self._token_cache = frames.astype(np.int32 if want_ndim == 3 else np.float32)
        if actions is None:
            actions = np.zeros((self.prompt_horizon, self.config.max_d_action), np.float32)
        self._action_cache = np.asarray(actions, np.float32)

    def reset(self):
        if self.physics is not None:
            obs = self.physics.reset()
            self.set_initial_state(np.stack([obs] * self.prompt_horizon))
        self._require_state()
        return self._current_frame()

    def _require_state(self):
        if self._token_cache is None:
            raise RuntimeError("call set_initial_state first")

    def _current_frame(self):
        frame = self._token_cache[-1]
        if self._decode is not None:
            return self._decode(frame[None])[0]
        return frame

    def _make_window(self) -> np.ndarray:
        """(1, H+1, ...) model input from the rolling cache: tokens get a
        masked final frame, latents a zero one (the MAR step starts that
        frame from the mask token)."""
        H = self.prompt_horizon
        if self.backbone == "stmaskgit":
            S = self.config.S
            return np.concatenate([
                self._token_cache.reshape(H, S),
                np.full((1, S), self.model.mask_token_id, np.int32)])[None]
        return np.concatenate([
            self._token_cache,
            np.zeros((1, *self._token_cache.shape[1:]), np.float32)])[None]

    def _step_tokens(self, window, actions, draws):
        """window (1, H+1, S) ids -> the next frame's (S,) ids."""
        model, H = self.model, self.prompt_horizon
        k_cache, v_cache = model.init_cache(1, with_actions=True)
        k_cache, v_cache = _prefill(model, window, k_cache, v_cache, actions,
                                    self.domain_id, H)
        masked = torch.full((1, self.config.S), model.mask_token_id,
                            dtype=window.dtype, device=self.device)
        tokens, _, _, _ = generate_frame(
            model, masked, H, k_cache, v_cache, actions, self.domain_id,
            self.generator, draws, maskgit_steps=self.maskgit_steps,
            temperature=self.temperature)
        return tokens[0]

    def _step_latents(self, window, actions, draws):
        """window (1, H+1, h, w, C) latents -> the next frame's (h, w, C)."""
        model, cfg, H = self.model, self.config, self.prompt_horizon
        p = cfg.patch_size
        patches = patchify(window, p).flatten(2, 3)  # (1, H+1, S_p, patch_dim)
        k_cache, v_cache = model.init_cache(1, with_actions=True)
        for t in range(H):
            _, _, k_cache, v_cache = model.frame_latents(
                patches[:, t], t, k_cache, v_cache, actions, self.domain_id)
        frame, _, _, _ = generate_frame_mar(
            model, H, k_cache, v_cache, actions, self.domain_id, self.generator,
            draws, maskgit_steps=self.maskgit_steps, temperature=self.temperature,
            batch_size=1)
        hp = cfg.h // p
        return unpatchify(frame.reshape(1, 1, hp, hp, -1), p, cfg.vae_embed_dim)[0, 0]

    @torch.no_grad()
    def _generate(self, window: np.ndarray, actions: np.ndarray, draws=None) -> np.ndarray:
        """One model step -> (h, w) int32 tokens or (h, w, C) float32
        latents (numpy). draws: optional, the frame's draws as tensors."""
        actions = torch.from_numpy(actions).to(self.device)
        if self.backbone == "stmaskgit":
            window = torch.from_numpy(window).to(self.device, torch.int64)
            out = self._step_tokens(window, actions, draws)
            return out.cpu().numpy().astype(np.int32).reshape(self.config.h, self.config.w)
        window = torch.from_numpy(window).to(self.device)
        return self._step_latents(window, actions, draws).float().cpu().numpy()

    def step(self, action: np.ndarray, draws=None):
        """Advance one frame under `action`. Returns decoded pixels (H, W, 3)
        uint8, or the tokens / latents when there is no decoder."""
        self._require_state()
        t0 = time.perf_counter()
        action = np.asarray(action, np.float32).reshape(-1)
        padded = np.zeros(self.config.max_d_action, np.float32)
        padded[:len(action)] = action
        window = self._make_window()
        actions = np.concatenate([self._action_cache, padded[None]])[None]
        frame = self._generate(window, actions, draws)
        step_time = time.perf_counter() - t0  # model time only

        out = frame if self._decode is None else self._decode(frame[None])[0]
        # the ground-truth physics under the same action: PSNR, and the
        # ΔPSNR controllability signal
        if self.physics is not None and self._decode is not None:
            gt = np.asarray(self.physics.step(action))
            if gt.shape == out.shape:
                gt_psnr = float(psnr(out, gt, device=self.device))
                self._psnr_history.append(gt_psnr)
                if self.compute_delta_psnr:
                    n = self.average_delta_psnr_over
                    delta = 0.0
                    for _ in range(n):
                        rand_actions = self._rng.normal(size=actions.shape).astype(np.float32)
                        rand_px = self._decode(self._generate(window, rand_actions)[None])[0]
                        delta += (gt_psnr - float(psnr(rand_px, gt, device=self.device))) / n
                    self._delta_psnr_history.append(delta)

        self._token_cache = np.concatenate([self._token_cache[1:], frame[None]])
        self._action_cache = np.concatenate([self._action_cache[1:], padded[None]])
        self._step_times.append(step_time)
        return out

    # ------------------------------------------------------------------

    def measure_step_time(self) -> dict:
        """Median and IQR-trimmed mean step latency (model time only)."""
        if not self._step_times:
            return {}
        ts = np.asarray(self._step_times)
        q1, q3 = np.percentile(ts, [25, 75])
        inlier = ts[(ts >= q1) & (ts <= q3)]
        stats = {
            "p50_ms": float(np.median(ts) * 1000),
            "iqr_mean_ms": float(np.mean(inlier) * 1000) if len(inlier) else float("nan"),
            "n": len(ts),
        }
        if self._psnr_history:
            stats["psnr_vs_physics"] = float(np.mean(self._psnr_history))
        if self._delta_psnr_history:
            stats["delta_psnr"] = float(np.mean(self._delta_psnr_history))
        return stats
