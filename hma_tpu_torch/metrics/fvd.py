"""FVD (counterpart of hma_tpu/metrics/fvd.py, its distance half): the
Fréchet distance between the embeddings of two video batches at the full
clip length, the value the reference's sweep over clip lengths >= 10 ends on.

The I3D backbones (the "videogpt" and "styleganv" variants) are not ported
yet (ROADMAP.md Queue A, item 6), so the embedding is the caller's
`embed_fn(videos) -> (N, D)`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from hma_tpu_torch.metrics.fid import _BACKBONES, fid_from_features


def calculate_fvd(pred_videos: np.ndarray, gt_videos: np.ndarray,
                  embed_fn: Callable) -> float:
    """(N, T, ...) batches, T >= 10 -> the Fréchet distance of their
    embeddings."""
    if embed_fn is None:
        raise NotImplementedError(_BACKBONES.format("I3D"))
    if pred_videos.shape[1] < 10:
        raise ValueError(f"FVD needs clips of >= 10 frames, got {pred_videos.shape[1]}")
    return float(fid_from_features(embed_fn(pred_videos), embed_fn(gt_videos)))
