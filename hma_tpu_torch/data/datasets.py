"""Memmap-backed token datasets (own numpy copy of the discrete part of
hma_tpu/data/datasets.py).

The on-disk format is byte-identical to `hma_tpu`'s and the reference's:
`video.bin` (uint32 (N, h, w) tokens), `segment_ids.bin` (int32),
`actions/*.bin` (float32) and `metadata.json`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from hma_tpu_torch.data.freq_table import DATA_FREQ_TABLE


def normalize_actions(actions: np.ndarray):
    """Per-dim mean/std stats; normalisation itself happens in the network."""
    mean = np.mean(actions, axis=0).tolist()
    std = np.std(actions, axis=0).tolist()
    return actions, [mean, std]


class RawTokenDataset:
    """uint32 (N, h, w) discrete MagVit2 tokens in windows of `window_size`
    frames, `stride` frames apart."""

    def __init__(self, data_dir, window_size, stride=1, filter_interrupts=True,
                 filter_overlaps=False, use_actions=False, name="",
                 max_traj_num=1_000_000, compute_stride_from_freq_table=True,
                 natural_hz=2, drop_action_ratio=0.0,
                 rng: Optional[np.random.Generator] = None):
        self.drop_action_ratio = drop_action_ratio
        self._rng = rng or np.random.default_rng()
        data_dir = Path(data_dir)
        with open(data_dir / "metadata.json") as f:
            self.metadata = json.load(f)
        token_dtype = np.dtype(self.metadata.get("token_dtype", "uint32"))
        shape = (self.metadata["num_images"], self.metadata["h"], self.metadata["w"])
        self.data = np.memmap(data_dir / "video.bin", dtype=token_dtype, mode="r",
                              shape=shape)
        self.window_size, self.stride = window_size, stride
        self.name = (name if name else self.metadata["name"]).replace("_noquant", "")
        if compute_stride_from_freq_table:
            self.stride = max(DATA_FREQ_TABLE.get(self.name, 1) // natural_hz, 1)

        if use_actions:
            actions = [np.memmap(f, dtype=np.float32, mode="r").reshape(len(self.data), -1)
                       for f in sorted((data_dir / "actions").iterdir())]
            self.actions, self.action_stat = normalize_actions(
                np.concatenate(actions, axis=-1))
        else:
            self.actions = None

        seg_path = data_dir / "segment_ids.bin"
        if os.path.isfile(seg_path):
            self.segment_ids = np.memmap(seg_path, dtype=np.int32, mode="r",
                                         shape=(self.metadata["num_images"],))
        else:
            self.segment_ids = None
            if filter_interrupts:
                raise NotImplementedError(
                    "Cannot filter interrupted sequences without segment ids.")

        self.video_len = (self.window_size - 1) * self.stride
        n = len(self.data) - self.video_len - self.stride
        valid = []
        for start in range(max(n, 0)):
            if not (filter_interrupts and self.segment_ids[start]
                    != self.segment_ids[start + self.video_len]):
                valid.append(start)
            if self.segment_ids is not None and self.segment_ids[start] >= max_traj_num:
                break
        if filter_overlaps:
            filtered = []
            for start in valid:
                overlapping = {start - i * self.stride for i in range(1, self.window_size)}
                if not any(e in overlapping
                           for e in filtered[-self.window_size * self.stride:]):
                    filtered.append(start)
            valid = filtered
        self.valid_start_inds = np.asarray(valid, dtype=np.int64)

    def __len__(self):
        return len(self.valid_start_inds)

    def _action_window(self, start: int) -> np.ndarray:
        """(window_size, action_dim * stride): all intra-stride actions."""
        a = self.actions[start: start + self.video_len + self.stride]
        return np.asarray(a, dtype=np.float32).reshape(self.window_size, -1)

    def __getitem__(self, idx):
        start = int(self.valid_start_inds[idx])
        x = np.asarray(self.data[start: start + self.video_len + 1: self.stride],
                       dtype=np.int64)
        d = {
            "input_ids": x.reshape(-1),
            "labels": x.reshape(-1),
            "h": self.metadata["h"],
            "w": self.metadata["w"],
            "domain": self.name,
        }
        if self.actions is not None and self._rng.uniform() > self.drop_action_ratio:
            d["action_ids"] = self._action_window(start)
        return d


def write_token_dataset(out_dir, video: np.ndarray, segment_ids: np.ndarray,
                        actions: Optional[np.ndarray], metadata: dict) -> None:
    """Write a token dataset directory, video (N, h, w), in the shared format."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    video.tofile(out / "video.bin")
    segment_ids.astype(np.int32).tofile(out / "segment_ids.bin")
    if actions is not None:
        (out / "actions").mkdir(exist_ok=True)
        actions.astype(np.float32).tofile(out / "actions" / "actions.bin")
        metadata = {**metadata, "action_dim": int(actions.shape[-1])}
    meta = {
        "num_images": int(video.shape[0]),
        "h": int(video.shape[1]),
        "w": int(video.shape[2]),
        "token_dtype": str(video.dtype),
        **metadata,
    }
    with open(out / "metadata.json", "w") as f:
        json.dump(meta, f)
