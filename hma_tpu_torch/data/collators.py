"""MaskGIT batch collators as pure numpy functions with an explicit RNG
(own copy of hma_tpu/data/collators.py).

Semantics mirror the reference collator (hma/data.py:28-90): Copilot4D-style
uniform token corruption at a random global rate; with prob
`non_mlm_ratio`, a "non-MLM" branch that leaves a random prompt prefix
unmasked and corrupts later frames with compounding rates, otherwise
standard MLM from frame 1; then per-(example, frame) cosine-scheduled
masking to `mask_token_id` (discrete) or to a `masked_tokens_indicator`
(continuous). Each draws from the given np.random.Generator in exactly the
order `hma_tpu`'s does, so the same seed gives the same batch.

Under data parallelism a process collates only its rows of the global batch
(`rows`, `batch_size`): it draws every random array at the global batch's
shape and keeps its rows, so the ranks' rows together are the batch one
process would collate.
"""

from __future__ import annotations

import numpy as np


def _cosine(u: np.ndarray) -> np.ndarray:
    return np.cos(u * np.pi / 2)


def _rows(batch: list, rows, batch_size) -> tuple:
    """(global batch size, row selector) of a collate of `batch`, the rows
    `rows` of a global batch of `batch_size` (both None: the whole batch)."""
    if rows is None:
        return len(batch), slice(None)
    if len(rows) != len(batch):
        raise ValueError(f"{len(batch)} items for {len(rows)} rows")
    return batch_size, np.asarray(rows)


def maskgit_collate(batch: list[dict], config, rng: np.random.Generator,
                    rows=None, batch_size=None) -> dict:
    """Discrete-token collator (reference: get_maskgit_collator, hma/data.py:28).

    batch: list of dataset items with "input_ids" (T*h*w,) int64; with
    `rows`, they are rows `rows` of a global batch of `batch_size`.
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
    G, sel = _rows(batch, rows, batch_size)
    full = (G, *x_THWC.shape[1:])

    random_values = rng.integers(0, fv, size=full)[sel]
    if config.dataloader_apply_corruption:
        u01 = rng.uniform()
        r = rng.uniform(size=full)[sel]
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
            r = rng.uniform(size=(G, h, w, nv))[sel]
            bad = r > correct_rate
            x_THWC[:, i] = np.where(bad, random_values[:, i], x_THWC[:, i])
    else:
        first_masked_frame = 1

    x_THW = np.sum(x_THWC * powers, axis=-1)  # unfactorize
    if config.dataloader_apply_mask:
        mask = np.zeros((G, T - first_masked_frame, h, w), dtype=bool)
        while not mask.any():  # reference loops until at least one token masked
            mask_prob_T = _cosine(rng.uniform(size=(G, T - first_masked_frame, 1, 1)))
            r = rng.uniform(size=(G, T - first_masked_frame, h, w))
            mask = r < mask_prob_T
        tail = x_THW[:, first_masked_frame:]
        x_THW[:, first_masked_frame:] = np.where(mask[sel], mask_token_id, tail)

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


def maskgit_collate_feature(batch: list[dict], config, rng: np.random.Generator,
                            rows=None, batch_size=None) -> dict:
    """Continuous-latent collator (reference: get_maskgit_collator_feature,
    hma/data.py:103): no corruption, the mask as `masked_tokens_indicator`
    (B, T, h, w) int32 instead of in place; input_ids and labels are the
    same latents (B, T*h*w, C) fp32. `rows`, `batch_size`: as
    `maskgit_collate`."""
    h, w = batch[0]["h"], batch[0]["w"]
    B, T = len(batch), config.T
    x = np.stack([ex["input_ids"] for ex in batch])  # (B, T*h*w, C)
    C = x.shape[-1]
    x_THWC = x.reshape(B, T, h, w, C)
    G, sel = _rows(batch, rows, batch_size)

    mask_token_indicator = np.zeros((B, T, h, w), dtype=np.int32)
    if config.dataloader_apply_mask:
        if rng.uniform() < config.non_mlm_ratio:
            lo = min(config.num_prompt_frames, config.T - 1)
            first_masked_frame = int(rng.integers(lo, config.T))
        else:
            first_masked_frame = 1
        mask = np.zeros((G, T - first_masked_frame, h, w), dtype=bool)
        while not mask.any():
            rand = rng.uniform(size=(G, T - first_masked_frame, 1, 1))
            lo_ratio = config.dataloader_mask_ratio_min
            mask_prob_T = _cosine(rand * (1 - lo_ratio) + lo_ratio)
            r = rng.uniform(size=(G, T - first_masked_frame, h, w))
            mask = r < mask_prob_T
        mask_token_indicator = np.concatenate(
            [np.zeros((B, first_masked_frame, h, w), dtype=np.int32),
             mask[sel].astype(np.int32)], axis=1)

    out = {
        "input_ids": x_THWC.reshape(B, T * h * w, C).astype(np.float32),
        "labels": x_THWC.reshape(B, T * h * w, C).astype(np.float32),
        "masked_tokens_indicator": mask_token_indicator,
        "domain": [ex["domain"] for ex in batch],
        "h": [h] * B,
        "w": [w] * B,
    }
    if all("action_ids" in ex for ex in batch):  # all-or-nothing, as above
        out["action_ids"] = np.stack([ex["action_ids"] for ex in batch]).astype(np.float32)
    return out
