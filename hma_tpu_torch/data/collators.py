"""MaskGIT batch collator as a pure numpy function with an explicit RNG
(own copy of the discrete part of hma_tpu/data/collators.py).

Semantics mirror the reference collator (hma/data.py:28-90): Copilot4D-style
uniform token corruption at a random global rate; with prob
`non_mlm_ratio`, a "non-MLM" branch that leaves a random prompt prefix
unmasked and corrupts later frames with compounding rates, otherwise
standard MLM from frame 1; then per-(example, frame) cosine-scheduled
masking to `mask_token_id`. It draws from the given np.random.Generator in
exactly the order `hma_tpu`'s does, so the same seed gives the same batch.
The continuous collator waits for the STMAR family.
"""

from __future__ import annotations

import numpy as np


def _cosine(u: np.ndarray) -> np.ndarray:
    return np.cos(u * np.pi / 2)


def maskgit_collate(batch: list[dict], config,
                    rng: np.random.Generator) -> dict:
    """Discrete-token collator (reference: get_maskgit_collator, hma/data.py:28).

    batch: list of dataset items with "input_ids" (T*h*w,) int64.
    Returns numpy dict with input_ids/labels (B, T*h*w) int32 + metadata.
    """
    h, w = batch[0]["h"], batch[0]["w"]
    B, T = len(batch), config.T
    nv, fv = config.num_factored_vocabs, config.factored_vocab_size
    mask_token_id = config.image_vocab_size

    x = np.stack([ex["input_ids"] for ex in batch]).reshape(B, T, h, w)
    labels = x.copy()
    powers = fv ** np.arange(nv)
    x_THWC = (x[..., None] // powers) % fv  # factorize

    random_values = rng.integers(0, fv, size=x_THWC.shape)
    if config.dataloader_apply_corruption:
        u01 = rng.uniform()
        r = rng.uniform(size=x_THWC.shape)
        corrupt = r < config.max_corrupt_rate * u01
        x_THWC = np.where(corrupt, random_values, x_THWC)

    if rng.uniform() < config.non_mlm_ratio:
        # leave frames [0, first_masked_frame) unmasked; corrupt later
        # frames with compounding rates (reference: hma/data.py:51-64)
        lo = min(config.num_prompt_frames, config.T - 1)
        first_masked_frame = int(rng.integers(lo, config.T))
        correct_rate = rng.uniform(config.dataloader_mask_ratio_min, 1.0)
        for i in range(first_masked_frame, T):
            correct_rate *= rng.uniform(0.9, 1.0)
            r = rng.uniform(size=(B, h, w, nv))
            bad = r > correct_rate
            x_THWC[:, i] = np.where(bad, random_values[:, i], x_THWC[:, i])
    else:
        first_masked_frame = 1

    x_THW = np.sum(x_THWC * powers, axis=-1)  # unfactorize
    if config.dataloader_apply_mask:
        mask = np.zeros((B, T - first_masked_frame, h, w), dtype=bool)
        while not mask.any():  # reference loops until at least one token masked
            mask_prob_T = _cosine(rng.uniform(size=(B, T - first_masked_frame, 1, 1)))
            r = rng.uniform(size=(B, T - first_masked_frame, h, w))
            mask = r < mask_prob_T
        tail = x_THW[:, first_masked_frame:]
        x_THW[:, first_masked_frame:] = np.where(mask, mask_token_id, tail)

    out = {
        "input_ids": x_THW.reshape(B, T * h * w).astype(np.int32),
        "labels": labels.reshape(B, T * h * w).astype(np.int32),
        "domain": [ex["domain"] for ex in batch],
        "h": [h] * B,
        "w": [w] * B,
    }
    # all-or-nothing: any item whose actions were dropped drops them for
    # the whole batch, which the model takes as one tensor
    if all("action_ids" in ex for ex in batch):
        out["action_ids"] = np.stack([ex["action_ids"] for ex in batch]).astype(np.float32)
    return out
