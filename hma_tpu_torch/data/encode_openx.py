"""Shard-parallel offline encoding of episode streams (counterpart of
hma_tpu/data/encode_openx.py).

Episodes stream on the host (TFDS/OpenX RLDS, or any iterable of episode
dicts), frames are center-cropped and resized on the CPU
(`tokenizer/image_ops.resize_image`), then batched and encoded on the card by
the MagVit2 encoder (discrete tokens) or the SVD-VAE encoder (continuous
latents). A shard is written in the standard on-disk layout (video.bin /
segment_ids.bin / actions/actions.bin / metadata.json, or error.json for an
empty shard), byte for byte what `hma_tpu` writes for the same codes.
`--shard_ind/--num_shards` split the episodes; any number of shards can run
against one card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.data.datasets import SVD_SCALE
from hma_tpu_torch.data.freq_table import (
    DATA_FREQ_TABLE,
    MAX_VAL_EXAMPLES,
    MIN_VAL_EXAMPLES,
    VAL_RATIO,
)
from hma_tpu_torch.data.merge_shards import SHARD_DATA_FORMAT
from hma_tpu_torch.rollout.decode import codec
from hma_tpu_torch.tokenizer.image_ops import normalize_image_np, resize_image
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE

# Observation-key preference order when episodes carry multiple cameras
# (reference: select_image, encode_openx_dataset.py:111-127).
IMAGE_KEY_CANDIDATES = (
    "image", "rgb", "agentview_rgb", "rgb_static", "front_rgb",
    "agentview_image", "image_1", "wrist_image", "hand_image",
)


def select_image(observation: dict) -> np.ndarray:
    for key in IMAGE_KEY_CANDIDATES:
        if key in observation:
            return np.asarray(observation[key])
    raise KeyError(f"no known image key in {sorted(observation)}")


def get_shard_inds(total: int, num_shards: int, shard_ind: int) -> tuple[int, int]:
    """[start, end) episode indices for this shard
    (reference: encode_openx_dataset.py:202-212)."""
    per = total / num_shards
    return round(per * shard_ind), round(per * (shard_ind + 1))


def val_split_size(total_episodes: int) -> int:
    """First VAL_RATIO of episodes, clipped to [20, 200]
    (reference: encode_openx_dataset.py:46-48)."""
    return int(np.clip(int(total_episodes * VAL_RATIO),
                       MIN_VAL_EXAMPLES, MAX_VAL_EXAMPLES))


def _batched(encode_chunk: Callable, batch_size: int, out_dtype) -> Callable:
    """encode_batch(frames (N, H, W, 3) uint8) -> the concatenated outputs
    of `encode_chunk` over batches of `batch_size`. A short last batch is
    zero-padded, so a frame's code does not depend on how many frames came
    with it (the conv algorithm may differ with the batch size)."""

    @torch.no_grad()
    def encode_batch(frames_uint8: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(frames_uint8), batch_size):
            chunk = frames_uint8[i:i + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out.append(encode_chunk(normalize_image_np(chunk))[:batch_size - pad])
        return np.concatenate(out).astype(out_dtype)

    return encode_batch


def make_magvit_encoder(state_dict_or_model: Union[dict, VQModel],
                        config: Optional[VQConfig] = None, batch_size: int = 64,
                        dtype=None, device=None):
    """Returns encode_batch(frames (N, H, W, 3) uint8) -> (N, h, w) np.uint32
    tokens, in batches of `batch_size` on the codec's device (the CUDA card
    unless told otherwise). `encode_batch.vocab_size` is the LFQ vocabulary,
    2**z_channels."""
    model = codec(state_dict_or_model, config, dtype, device)
    device = next(model.parameters()).device

    def encode_chunk(x: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(x).to(device).permute(0, 3, 1, 2)
        return model.encode(x).indices.cpu().numpy()

    encode_batch = _batched(encode_chunk, batch_size, np.uint32)
    encode_batch.vocab_size = 2 ** model.config.z_channels
    return encode_batch


def make_svd_encoder(vae: Union[None, dict, SVDTemporalVAE] = None, batch_size: int = 32,
                     dtype=None, device=None):
    """Returns encode_batch(frames (N, H, W, 3) uint8) -> (N, C, h, w)
    float16 latents, the SVD-VAE encoder's mean x SVD_SCALE (reference:
    get_vae_image_embeddings, datasets/utils.py:150-197), in batches of
    `batch_size` on the card unless told otherwise.

    `vae`: the port's `SVDTemporalVAE`, or a state dict of the released
    architecture in its diffusers layout (keys under `loss` and `ema` are
    dropped), or None for the seed-0 random init (pipeline testing only, as
    in `hma_tpu`; its init draws differ from JAX's). Built here, it runs in
    bf16 on the card and fp32 on the CPU. The latents are scaled and cast in
    fp32, then rounded to float16 on the host."""
    if isinstance(vae, SVDTemporalVAE):
        model = vae.eval()
    else:
        device = resolve_device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
        model = SVDTemporalVAE(dtype=dtype, device=device,
                               generator=torch.Generator(device).manual_seed(0)).eval()
        if vae is not None:
            model.load_state_dict({k: v for k, v in vae.items()
                                   if not k.startswith(("loss", "ema"))})
    device = next(model.parameters()).device

    def encode_chunk(x: np.ndarray) -> np.ndarray:
        z = model.encode(torch.from_numpy(x).to(device, model.dtype)).float()
        return (z * SVD_SCALE).permute(0, 3, 1, 2).cpu().numpy()  # (B, C, h, w)

    return _batched(encode_chunk, batch_size, np.float16)


def encode_episodes(episodes: Iterable[dict], out_dir: str, name: str, *,
                    encode_batch: Optional[Callable] = None,
                    keep_res: bool = False,
                    episode_timeout_s: float = 2 * 24 * 3600,
                    image_size: int = 256) -> dict:
    """Encode an iterable of episodes into one shard directory.

    episodes: iterable of {"steps": iterable of {"image"/obs dict,
    "action": (da,)}}. An episode that raises is reported and skipped
    (reference :325-327); episodes past `episode_timeout_s` are not read.
    With no `encode_batch` the resized uint8 frames are written. Returns the
    metadata dict written, or {} (and error.json) for an empty shard.
    (reference main loop: encode_openx_dataset.py:290-388)
    """
    frames, actions, segment_ids = [], [], []
    t_start = time.time()
    n_episodes = 0
    for ep_idx, episode in enumerate(episodes):
        if time.time() - t_start > episode_timeout_s:
            break
        try:
            steps = episode["steps"] if isinstance(episode, dict) else episode
            for step in steps:
                obs = step.get("observation", step)
                img = select_image(obs) if isinstance(obs, dict) else np.asarray(obs)
                img = resize_image(img, target=image_size, keep_res=keep_res)
                frames.append(img)
                actions.append(np.asarray(step.get("action", np.zeros(1)),
                                          np.float32).reshape(-1))
                segment_ids.append(ep_idx)
            n_episodes += 1
        except Exception as e:  # per-episode tolerance
            print(f"episode {ep_idx} failed: {e!r}")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not frames:
        with open(out / "error.json", "w") as f:
            json.dump({"error": "empty shard"}, f)
        return {}

    frames = np.stack(frames)
    da = max(a.shape[0] for a in actions)
    action_arr = np.zeros((len(actions), da), np.float32)
    for i, a in enumerate(actions):
        action_arr[i, :len(a)] = a

    if encode_batch is not None:
        video = encode_batch(frames)
        if video.ndim == 4:  # (N, C, h, w) continuous latents
            extra = {"token_dtype": str(video.dtype),
                     "latent_channels": int(video.shape[1])}
        else:                # (N, h, w) discrete tokens
            extra = {"vocab_size": getattr(encode_batch, "vocab_size", 2**18),
                     "token_dtype": "uint32"}
    else:
        video = frames  # raw uint8 images
        extra = {"token_dtype": "uint8"}

    if video.ndim == 4 and "latent_channels" in extra:
        h, w = video.shape[2], video.shape[3]
    else:
        h, w = video.shape[1], video.shape[2]
    video.tofile(out / "video.bin")
    np.asarray(segment_ids, np.int32).tofile(out / "segment_ids.bin")
    (out / "actions").mkdir(exist_ok=True)
    action_arr.tofile(out / "actions" / "actions.bin")
    meta = {
        "num_images": int(video.shape[0]),
        "h": int(h), "w": int(w), "s": int(h * w),
        "name": name,
        "action_dim": int(da),
        "num_episodes": n_episodes,
        "hz": DATA_FREQ_TABLE.get(name, 1),
        **extra,
    }
    with open(out / "metadata.json", "w") as f:
        json.dump(meta, f)
    return meta


def tfds_episode_stream(dataset_name: str, split: str, shard_ind: int,
                        num_shards: int,
                        gcs_root: str = "gs://gresearch/robotics"):
    """Stream episodes from a TFDS RLDS builder (reference:
    get_dataset_builder, encode_openx_dataset.py:184-199). Needs the
    `tensorflow_datasets` package and the dataset under `gcs_root`."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(
            f"reading {dataset_name!r} from TFDS needs the tensorflow_datasets "
            f"package and the dataset under {gcs_root}; pass episodes to "
            "encode_episodes instead") from e

    builder = tfds.builder_from_directory(f"{gcs_root}/{dataset_name}/0.1.0")
    total = builder.info.splits[split].num_examples
    start, end = get_shard_inds(total, num_shards, shard_ind)
    ds = builder.as_dataset(split=f"{split}[{start}:{end}]")
    for ep in tfds.as_numpy(ds):
        yield ep


def main(argv=None):
    p = argparse.ArgumentParser(description="Encode an OpenX dataset shard")
    p.add_argument("--dataset_name", type=str, required=True)
    p.add_argument("--data_split", type=str, default="train")
    p.add_argument("--shard_ind", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--encoder_type", type=str, default="magvit",
                   choices=["magvit", "temporalvae", "raw"])
    p.add_argument("--encoder_name_or_path", type=str, default="data/magvit2.ckpt")
    p.add_argument("--out_root", type=str, default="data")
    p.add_argument("--keep_res", action="store_true")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    encode_batch = None
    suffix = "raw"
    if args.encoder_type == "magvit":
        from hma_tpu_torch.tokenizer.convert import load_magvit2

        encode_batch = make_magvit_encoder(
            *load_magvit2(args.encoder_name_or_path),
            batch_size=args.batch_size, device=device)
        suffix = "magvit"
    elif args.encoder_type == "temporalvae":
        # the seed-0 random init, as hma_tpu's CLI (pipeline testing only)
        encode_batch = make_svd_encoder(batch_size=args.batch_size, device=device)
        suffix = "vae"

    out_dir = SHARD_DATA_FORMAT.format(root=args.out_root, name=args.dataset_name,
                                       suffix=suffix, i=args.shard_ind, n=args.num_shards,
                                       split=args.data_split)
    episodes = tfds_episode_stream(args.dataset_name, args.data_split,
                                   args.shard_ind, args.num_shards)
    meta = encode_episodes(episodes, out_dir, args.dataset_name,
                           encode_batch=encode_batch, keep_res=args.keep_res)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
