"""EPIC-KITCHENS episode generator: hand-object detections -> delta actions.

Rebuild of the reference generator (datasets/extern/epic_kitchen.py:59-113)
with its full semantics:

  - frames live under {root}/{participant}/rgb_frames/{video_id}/
    frame_%010d.jpg; per-video hand-object detections in
    {detections_root}/{participant}/{video_id}.pkl (the
    epic-kitchens-100-hand-object-bboxes release);
  - frames without exactly two hand detections are skipped
    (epic_kitchen.py:82-87);
  - hands are ordered (left, right) by their side label; state = current
    hand bbox centers (the release stores them normalized), and —
    unlike Ego4D/EgoExo4D — action = center DELTAS next - current
    (compute_state_and_actions, epic_kitchen.py:33-56);
  - episodes cap at MAX_EPISODE_LENGTH (5000).

The reference depends on the `epic_kitchens` package for the pickle
types; this port uses it when importable and otherwise accepts
plain-dict detections (a list of {"hands": [{"side": "left"|"right",
"center": (x, y)}]} per frame), which is also the format the unit-test
fixtures synthesize. Root from $EPIC_KITCHEN_ROOT; frames resized to
`image_size`.

The port's copy of hma_tpu/data/extern/epic_kitchen.py: the same episodes from the
same inputs.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

from hma_tpu_torch.data.encode_openx import get_shard_inds
from hma_tpu_torch.data.extern.ego4d import resize_frame

EPIC_ROOT = os.environ.get("EPIC_KITCHEN_ROOT", "/datasets/epic_kitchens")
EPIC_DETECTIONS = os.environ.get("EPIC_KITCHEN_DETECTIONS",
                                 os.path.join(EPIC_ROOT, "hand-objects"))
MAX_EPISODE_LENGTH = 5000


def _frame_hands(frame) -> Optional[tuple]:
    """(left_center, right_center) normalized, or None unless exactly two
    hands are present (reference: epic_kitchen.py:33-47,82-87)."""
    hands = frame["hands"] if isinstance(frame, dict) else frame.hands
    if len(hands) != 2:
        return None

    def center(h):
        if isinstance(h, dict):
            return np.asarray(h["center"], np.float32)
        return np.asarray(h.bbox.center, np.float32)

    def side(h):
        s = h["side"] if isinstance(h, dict) else h.side
        return str(getattr(s, "name", s)).lower()

    h1, h2 = hands
    if "left" not in side(h1):  # flip so (left, right)
        h1, h2 = h2, h1
    return center(h1), center(h2)


def compute_state_and_actions(curr_frame, next_frame) -> Optional[tuple]:
    """state = current centers; action = next - current center deltas."""
    c, n = _frame_hands(curr_frame), _frame_hands(next_frame)
    if c is None or n is None:
        return None
    state = np.concatenate(c)
    action = np.concatenate([n[0] - c[0], n[1] - c[1]])
    return state, action


def load_detections(path: str) -> list:
    """Per-frame detections: the epic_kitchens release pickle when the
    package is importable, else a plain pickled list of dicts."""
    try:
        from epic_kitchens.hoa import load_detections as _ld  # type: ignore

        return _ld(path)
    except ImportError:
        with open(path, "rb") as f:
            return pickle.load(f)


def read_frame(frames_dir: str, frame_idx: int) -> Optional[np.ndarray]:
    """frame_%010d.jpg -> RGB (reference: epic_kitchen.py:93-99).

    Note the reference indexes filenames from 0 while EPIC's released rgb
    frames start at frame_0000000001.jpg — kept byte-for-byte (frame 0 is
    simply skipped as missing, and images lag detections by one frame the
    same way they do in the reference pipeline)."""
    import cv2

    path = os.path.join(frames_dir, f"frame_{frame_idx:010d}.jpg")
    img = cv2.imread(path)
    return img[..., ::-1] if img is not None else None


def iter_video_episode(frames_dir: str, detections: list,
                       image_size: int = 256, ds_factor: int = 1):
    """One episode from one video's frames + detections (or None)."""
    max_frame_idx = len(detections) - 1
    steps = []
    for idx in range(0, max_frame_idx - ds_factor, ds_factor):
        sa = compute_state_and_actions(detections[idx],
                                       detections[idx + ds_factor])
        if sa is None:
            continue
        image = read_frame(frames_dir, idx)
        if image is None:
            continue
        state, action = sa
        steps.append({
            "image": resize_frame(image, image_size),
            "state": state,
            "action": action,
            "language": "use human hands to do some tasks",
        })
        if len(steps) > MAX_EPISODE_LENGTH:
            break
    return {"steps": steps} if steps else None


def epic_kitchen_episode_generator(shard_ind: int, num_shards: int,
                                   root: str = EPIC_ROOT,
                                   detections_root: Optional[str] = None,
                                   image_size: int = 256):
    detections_root = detections_root or EPIC_DETECTIONS
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"EPIC-KITCHENS frames not found at {root}; set $EPIC_KITCHEN_ROOT")
    # enumerate (participant, video_id) pairs with frames on disk
    videos = []
    for eps in sorted(os.listdir(root)):
        rgb = Path(root) / eps / "rgb_frames"
        if not rgb.is_dir():
            continue
        for video_id in sorted(os.listdir(rgb)):
            if (rgb / video_id).is_dir():
                videos.append((eps, video_id))
    start, end = get_shard_inds(len(videos), num_shards, shard_ind)
    for participant, video_id in videos[start:end]:
        det_path = Path(detections_root) / participant / f"{video_id}.pkl"
        if not det_path.exists():
            continue
        detections = load_detections(str(det_path))
        ep = iter_video_episode(
            str(Path(root) / participant / "rgb_frames" / video_id),
            detections, image_size)
        if ep:
            yield ep
