"""Procedural action-conditioned world: the framework's dynamics probe.

A deterministic 2-object world rendered to pixels, built to prove the
full stack (tokenizer training -> encode -> STMaskGIT training with the
native loader -> held-out evaluation) learns *action-conditioned
dynamics that generalize*, not just memorization. The reference's
quality-control loop is exactly this kind of held-out protocol
(teacher-forced val metrics hma/train_multi.py:641-728, AR-rollout
PSNR hma/evaluate.py:324-464, 5-trial dPSNR controllability
hma/evaluate.py:352-376); its real robot datasets are not in this
image, so this world stands in as a fully-specified, seedable source.

World spec (everything integer-rendered so a small VQ tokenizer can be
near-lossless):
  - canvas `image_size`^2 RGB over a SOLID dark background. Sprites are
    deliberately large (the agent covers ~10% of pixels) and the
    background flat: the probe tokenizer trains on plain L1 (no GAN /
    LPIPS), and a first toyworld draft with 10px sprites on a
    checkerboard collapsed — the codec reproduced only the background
    (2.4% L1 from sprites wasn't worth codebook capacity) and every
    frame encoded to identical tokens, which silently made all dynamics
    metrics degenerate (PSNR(pred,gt) == PSNR(copy,gt) == 168 dB);
  - an agent: bright red square, driven by a continuous 2-D action
    a_t in [-1, 1]^2; pos_{t+1} = bounce(pos_t + a_t * MAX_SPEED).
    Actions are piecewise-constant random segments (3-6 frames) so
    held-out trajectories are predictable from actions alone.
    MAX_SPEED is deliberately large (~60% of the agent's side per
    frame): at 5 px/frame the copy-last-frame baseline scored 34.5 dB
    (sprites barely move relative to their size) and no prediction
    through a lossy codec could beat it — the world must make frame
    t+1 genuinely different from frame t for `psnr_vs_copy > 0` to
    measure dynamics rather than codec fidelity;
  - a distractor: green square with a constant per-episode ballistic
    velocity, bouncing off walls — un-actioned dynamics the model must
    learn unconditionally.

action[t] is the action applied between frame t and frame t+1 (the
robot-data convention the collators assume). Episodes are deterministic
functions of (split, episode index): train/val draw from disjoint seed
spaces, so val episodes are genuinely held out.

The port's copy of hma_tpu/data/extern/toyworld.py: the same episodes from the
same inputs.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from hma_tpu_torch.data.encode_openx import get_shard_inds

MAX_SPEED = 12.0         # px per frame at image_size=64, scaled with size
AGENT_SIDE = 20          # px at image_size=64 (~10% of pixels)
DISTRACTOR_SIDE = 14     # px at image_size=64
NUM_EPISODES = {"train": 480, "val": 48}
EPISODE_LEN = 40
_SPLIT_SEED = {"train": 0, "val": 1 << 20}


def _background(size: int) -> np.ndarray:
    """Solid dark background (see the module docstring for why flat)."""
    bg = np.empty((size, size, 3), np.uint8)
    bg[...] = 30
    return bg


def _paint(canvas: np.ndarray, cx: float, cy: float, side: int,
           color: tuple) -> None:
    """Draw a filled square centered at (cx, cy), integer-snapped."""
    size = canvas.shape[0]
    half = side // 2
    x0 = int(round(cx)) - half
    y0 = int(round(cy)) - half
    x0 = max(0, min(size - side, x0))
    y0 = max(0, min(size - side, y0))
    canvas[y0:y0 + side, x0:x0 + side] = color


def _bounce(p: float, v: float, lo: float, hi: float) -> tuple:
    """Advance p by v with reflective walls; returns (p', v')."""
    p = p + v
    if p < lo:
        p, v = 2 * lo - p, -v
    if p > hi:
        p, v = 2 * hi - p, -v
    return float(np.clip(p, lo, hi)), v


def piecewise_actions(rng: np.random.Generator, n: int,
                      hold_lo: int = 3, hold_hi: int = 6) -> np.ndarray:
    """(n, 2) float32 in [-1, 1], constant over random 3-6 frame holds."""
    out = np.zeros((n, 2), np.float32)
    i = 0
    while i < n:
        hold = int(rng.integers(hold_lo, hold_hi + 1))
        out[i:i + hold] = rng.uniform(-1.0, 1.0, 2).astype(np.float32)
        i += hold
    return out


def render_frame(bg: np.ndarray, agent_xy, distractor_xy,
                 scale: float) -> np.ndarray:
    frame = bg.copy()
    dx, dy = distractor_xy
    _paint(frame, dx, dy, max(2, int(round(DISTRACTOR_SIDE * scale))),
           (40, 220, 60))
    ax, ay = agent_xy
    _paint(frame, ax, ay, max(2, int(round(AGENT_SIDE * scale))),
           (230, 40, 40))
    return frame


def simulate_episode(ep_seed: int, episode_len: int = EPISODE_LEN,
                     image_size: int = 64) -> dict:
    """Deterministic episode: {"frames": (T,H,W,3) u8, "actions": (T,2)}.

    Frame t is rendered BEFORE action t is applied; actions[T-1] pads
    with zeros (no successor frame), matching the robot-data layout the
    collators consume.
    """
    rng = np.random.default_rng(ep_seed)
    scale = image_size / 64.0
    speed = MAX_SPEED * scale
    bg = _background(image_size)
    margin = (AGENT_SIDE * scale) / 2 + 1
    lo, hi = margin, image_size - margin

    ax = float(rng.uniform(lo, hi))
    ay = float(rng.uniform(lo, hi))
    dx = float(rng.uniform(lo, hi))
    dy = float(rng.uniform(lo, hi))
    theta = float(rng.uniform(0, 2 * np.pi))
    dvx = float(np.cos(theta)) * speed * 0.6
    dvy = float(np.sin(theta)) * speed * 0.6

    actions = piecewise_actions(rng, episode_len)
    actions[-1] = 0.0
    frames = np.empty((episode_len, image_size, image_size, 3), np.uint8)
    for t in range(episode_len):
        frames[t] = render_frame(bg, (ax, ay), (dx, dy), scale)
        vx, vy = actions[t, 0] * speed, actions[t, 1] * speed
        ax, _ = _bounce(ax, vx, lo, hi)
        ay, _ = _bounce(ay, vy, lo, hi)
        dx, dvx = _bounce(dx, dvx, lo, hi)
        dy, dvy = _bounce(dy, dvy, lo, hi)
    return {"frames": frames, "actions": actions}


def toyworld_dataset_size(split: str = "train") -> int:
    return NUM_EPISODES[split]


def toyworld_episode_generator(shard_ind: int, num_shards: int,
                               split: str = "train", image_size: int = 64,
                               episode_len: int = EPISODE_LEN,
                               example_inds: Optional[Iterable[int]] = None):
    """Yields {"steps": [{"image", "action", "language"}, ...]} episodes
    in the shared `encode_episodes` step format (encode_openx.py:135)."""
    if example_inds is None:
        start, end = get_shard_inds(toyworld_dataset_size(split), num_shards,
                                    shard_ind)
        example_inds = range(start, end)
    base = _SPLIT_SEED[split]
    for idx in example_inds:
        ep = simulate_episode(base + idx, episode_len, image_size)
        steps = [{"image": f, "action": a, "language": "toyworld"}
                 for f, a in zip(ep["frames"], ep["actions"])]
        yield {"steps": steps}
