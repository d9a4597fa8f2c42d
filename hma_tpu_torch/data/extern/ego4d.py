"""Ego4D episode generator: FHO narrated-action clips + hand-center actions.

Rebuild of the reference generator (datasets/extern/ego4d.py:151-226)
with its full semantics:

  - annotations: fho_main.json; per video, per annotated interval, keep
    narrated actions that are valid (not rejected/invalid, stage set),
    require >= 3 of them (ego4d.py:183-193);
  - actions are chunked 4-at-a-time (last partial chunk dropped) and
    their critical-frame lists concatenated (ego4d.py:128-141);
  - per consecutive frame pair with > 2 annotated boxes each:
    state = current left/right hand bbox centers (normalized by image
    size), action = NEXT-frame hand centers — absolute positions, not
    deltas (compute_state_and_actions, ego4d.py:50-112);
  - clips shorter than 16 steps are skipped (ego4d.py:222-224).

Differences by design: dataset root comes from $EGO4D_ROOT instead of
hardcoded /datasets01 paths; frames are resized to `image_size`
(the tokenizer's 256 input; the reference leaves frames raw here and
resizes downstream); frame decode goes through the module-level
`parse_video_frame` so tests can inject synthetic frames.

The port's copy of hma_tpu/data/extern/ego4d.py: the same episodes from the
same inputs.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from hma_tpu_torch.data.encode_openx import get_shard_inds

EGO4D_ROOT = os.environ.get("EGO4D_ROOT", "/datasets/ego4d")
MIN_STEPS = 16


def parse_video_frame(video_path: str, frame_id: int) -> Optional[np.ndarray]:
    """Decode one frame (1-indexed, matching the reference's
    cv2.CAP_PROP_POS_FRAMES seek, ego4d.py:32-36). Returns RGB."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, frame_id - 1)
    ok, frame = cap.read()
    cap.release()
    return frame[..., ::-1] if ok else None


def resize_frame(img: np.ndarray, image_size: int) -> np.ndarray:
    if img.shape[0] == image_size and img.shape[1] == image_size:
        return img
    import cv2

    return cv2.resize(img, (image_size, image_size))


def _hand_centers(boxes: list) -> Optional[tuple]:
    """(left_center, right_center) in pixels from FHO box annotations, or
    None when either hand is missing (reference crashes into its bare
    `except` instead, ego4d.py:207-213)."""
    left = right = None
    for box in boxes:
        c = (box["bbox"]["x"] + box["bbox"]["width"] / 2,
             box["bbox"]["y"] + box["bbox"]["height"] / 2)
        if box["object_type"] == "left_hand":
            left = c
        elif box["object_type"] == "right_hand":
            right = c
    if left is None or right is None:
        return None
    return left, right


def compute_state_and_actions(image: np.ndarray, curr_boxes: list,
                              next_boxes: list) -> Optional[tuple]:
    """state = current hand centers, action = next-frame hand centers,
    both normalized by (width, height) (reference: ego4d.py:50-95)."""
    h, w = image.shape[0], image.shape[1]
    curr = _hand_centers(curr_boxes)
    nxt = _hand_centers(next_boxes)
    if curr is None or nxt is None:
        return None
    norm = lambda c: np.asarray([c[0] / w, c[1] / h], np.float32)
    state = np.concatenate([norm(curr[0]), norm(curr[1])])
    action = np.concatenate([norm(nxt[0]), norm(nxt[1])])
    return state, action


def chunk_actions_and_concatenate(actions: list, chunk_size: int = 4) -> list:
    """Group narrated actions 4-at-a-time (dropping the last partial
    group) and concatenate their critical-frame lists
    (reference: ego4d.py:128-141)."""
    chunks = [actions[i:i + chunk_size]
              for i in range(0, len(actions), chunk_size)][:-1]
    out = []
    for chunk in chunks:
        frames = []
        for action in chunk:
            if action.get("frames"):
                frames.extend(action["frames"])
        out.append(frames)
    return out


def iter_episodes(labels: dict, video_dir: str,
                  example_inds: Optional[Iterable[int]] = None,
                  image_size: int = 256):
    """Yields {"steps": [{"image", "state", "action", "language"}...]}."""
    videos = labels["videos"]
    if example_inds is None:
        example_inds = range(len(videos))
    for ind in example_inds:
        label = videos[ind]
        video_path = str(Path(video_dir) / f"{label['video_uid']}.mp4")
        if not os.path.exists(video_path):
            continue
        for interval in label.get("annotated_intervals", []):
            actions = [a for a in interval.get("narrated_actions", [])
                       if not (a.get("is_invalid_annotation")
                               or a.get("is_rejected"))
                       and a.get("stage") is not None]
            if len(actions) < 3:
                continue
            for frames in chunk_actions_and_concatenate(actions):
                steps = []
                for idx, frame in enumerate(frames[:-1]):
                    nxt = frames[idx + 1]
                    if len(frame.get("boxes", [])) <= 2 or \
                            len(nxt.get("boxes", [])) <= 2:
                        continue
                    image = parse_video_frame(video_path, frame["frame_number"])
                    if image is None:
                        continue
                    sa = compute_state_and_actions(image, frame["boxes"],
                                                   nxt["boxes"])
                    if sa is None:
                        continue
                    state, action = sa
                    steps.append({
                        "image": resize_frame(image, image_size),
                        "state": state,
                        "action": action,
                        "language": "use human hands to do some tasks",
                    })
                if len(steps) < MIN_STEPS:
                    continue
                yield {"steps": steps}


def ego4d_dataset_size(root: str = EGO4D_ROOT) -> int:
    labels = json.load(open(Path(root) / "v2_1/annotations/fho_main.json"))
    return len(labels["videos"])


def ego4d_episode_generator(shard_ind: int, num_shards: int,
                            root: str = EGO4D_ROOT, image_size: int = 256):
    """Sharded generator over the FHO videos (encode_extern entry)."""
    ann_path = Path(root) / "v2_1/annotations/fho_main.json"
    if not ann_path.exists():
        raise FileNotFoundError(
            f"Ego4D annotations not found at {ann_path}; set $EGO4D_ROOT")
    labels = json.loads(ann_path.read_text())
    start, end = get_shard_inds(len(labels["videos"]), num_shards, shard_ind)
    yield from iter_episodes(labels, str(Path(root) / "v2_1/full_scale"),
                             range(start, end), image_size)
