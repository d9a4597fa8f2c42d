"""EgoExo4D episode generator: wrist-position actions from hand-pose labels.

Rebuild of the reference generator (datasets/extern/egoexo4d.py:97-199)
with its full semantics:

  - takes.json lists takes; per take, the automatic hand-pose file
    annotations/ego_pose/train/hand/automatic/{take_uid}.json maps frame
    index (string) -> pose annotations, and the video is
    takes/{take_name}/frame_aligned_videos/{cam}.mp4 (cam01);
  - frames are scanned for *continuous* labeled chunks (a gap in the
    annotation keys ends a chunk); chunks shorter than MIN_CLIP_LENGTH
    (300) are skipped (egoexo4d.py:141-168);
  - per frame: state = current left/right wrist positions from
    annotation2D[cam], normalized by image size; action = NEXT-frame
    wrists — absolute, not deltas (compute_state_and_actions,
    egoexo4d.py:30-75); a missing wrist ends the chunk (the reference's
    bare `except: break`).

Reference quirk NOT replicated: the original yields a chunk only `if
len(steps) < MIN_CLIP_LENGTH` (egoexo4d.py:196) — i.e. it *drops* every
chunk it worked to build and emits only truncated tails; we yield every
qualifying chunk, which is the evident intent. Root from $EGOEXO4D_ROOT;
frames resized to `image_size`; decode goes through `parse_raw_video`
so tests can inject synthetic frames.

The port's copy of hma_tpu/data/extern/egoexo4d.py: the same episodes from the
same inputs.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from hma_tpu_torch.data.encode_openx import get_shard_inds
from hma_tpu_torch.data.extern.ego4d import resize_frame

EGOEXO4D_ROOT = os.environ.get("EGOEXO4D_ROOT", "/datasets/egoexo4d")
CAM = "cam01"
MIN_CLIP_LENGTH = 300
MAX_EPISODE_LENGTH = 5000


def parse_raw_video(video_path: str) -> list:
    """All frames of a video, RGB (reference: egoexo4d.py:78-88)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return frames


def compute_state_and_actions(image: np.ndarray, curr: list, nxt: list,
                              cam: str = CAM) -> Optional[tuple]:
    """Wrist positions normalized by image size; None when a wrist is
    missing (reference: egoexo4d.py:30-75)."""
    h, w = image.shape[0], image.shape[1]

    def wrists(frame_anns):
        try:
            ann = frame_anns[0]["annotation2D"][cam]
            lw, rw = ann["left_wrist"], ann["right_wrist"]
        except (KeyError, IndexError, TypeError):
            return None
        return (np.asarray([lw["x"] / w, lw["y"] / h], np.float32),
                np.asarray([rw["x"] / w, rw["y"] / h], np.float32))

    c, n = wrists(curr), wrists(nxt)
    if c is None or n is None:
        return None
    return np.concatenate(c), np.concatenate(n)


def _continuous_chunk_end(start_idx: int, detections: dict) -> int:
    """First index after `start_idx` where the labels stop being
    continuous and non-empty (reference: egoexo4d.py:152-161)."""
    end = start_idx + 1
    while (str(end - 1) in detections and detections[str(end - 1)]
           and str(end) in detections and detections[str(end)]):
        end += 1
    return end


def iter_take_episodes(video_frames: list, detections: dict,
                       image_size: int = 256, ds_factor: int = 1,
                       min_clip: int = MIN_CLIP_LENGTH, cam: str = CAM):
    """Chunked episodes from one take's frames + hand-pose labels."""
    max_frame_idx = len(video_frames) - 1
    start = 0
    while start < max_frame_idx - ds_factor:
        if str(start) not in detections or \
                str(start + ds_factor) not in detections:
            start += ds_factor
            continue
        end = _continuous_chunk_end(start, detections)
        if end - start < min_clip:
            start = end
            continue
        steps = []
        for idx in range(start, min(end - ds_factor, max_frame_idx),
                         ds_factor):
            image = video_frames[idx]
            sa = compute_state_and_actions(
                image, detections[str(idx)], detections[str(idx + ds_factor)],
                cam)
            if sa is None:
                break  # matches the reference's `except: break`
            state, action = sa
            steps.append({
                "image": resize_frame(np.asarray(image), image_size),
                "state": state,
                "action": action,
                "language": "use human hands to do some tasks",
            })
            if len(steps) > MAX_EPISODE_LENGTH:
                break
        start = end
        if len(steps) >= min_clip:
            yield {"steps": steps}


def egoexo4d_dataset_size(root: str = EGOEXO4D_ROOT) -> int:
    return len(json.load(open(Path(root) / "takes.json")))


def egoexo4d_episode_generator(shard_ind: int, num_shards: int,
                               root: str = EGOEXO4D_ROOT,
                               image_size: int = 256,
                               example_inds: Optional[Iterable[int]] = None):
    take_path = Path(root) / "takes.json"
    if not take_path.exists():
        raise FileNotFoundError(
            f"EgoExo4D takes.json not found at {take_path}; set $EGOEXO4D_ROOT")
    takes = json.loads(take_path.read_text())
    if example_inds is None:
        start, end = get_shard_inds(len(takes), num_shards, shard_ind)
        example_inds = range(start, end)
    for ind in example_inds:
        take = takes[ind]
        video_path = Path(root) / "takes" / take["take_name"] / \
            "frame_aligned_videos" / f"{CAM}.mp4"
        label_path = Path(root) / "annotations/ego_pose/train/hand/automatic" \
            / f"{take['take_uid']}.json"
        if not video_path.exists() or not label_path.exists():
            continue
        frames = parse_raw_video(str(video_path))
        detections = json.loads(label_path.read_text())
        yield from iter_take_episodes(frames, detections, image_size)
