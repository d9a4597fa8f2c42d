"""Encode non-RLDS sources (ego video, robomimic sim, the procedural
toyworld) via python generators (counterpart of hma_tpu/data/encode_extern.py).

Rebuild of datasets/encode_extern_dataset.py: a registry maps dataset
names to (generator_factory, approx_size); the shared `encode_episodes`
writer handles batching, tolerance, and `error.json` markers for empty
shards (reference: encode_extern_dataset.py:40-44, 159-164). The frames
are resized on the host and encoded on the card (`--device`, default cuda).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

from hma_tpu_torch import resolve_device
from hma_tpu_torch.data.encode_openx import encode_episodes, make_magvit_encoder
from hma_tpu_torch.data.merge_shards import SHARD_DATA_FORMAT


def _ego4d(shard_ind: int, num_shards: int):
    from hma_tpu_torch.data.extern.ego4d import ego4d_episode_generator

    return ego4d_episode_generator(shard_ind, num_shards)


def _egoexo4d(shard_ind: int, num_shards: int):
    from hma_tpu_torch.data.extern.egoexo4d import egoexo4d_episode_generator

    return egoexo4d_episode_generator(shard_ind, num_shards)


def _robomimic(shard_ind: int, num_shards: int):
    from hma_tpu_torch.data.extern.robomimic import robomimic_episode_generator

    return robomimic_episode_generator(shard_ind, num_shards)


def _epic_kitchen(shard_ind: int, num_shards: int):
    from hma_tpu_torch.data.extern.epic_kitchen import epic_kitchen_episode_generator

    return epic_kitchen_episode_generator(shard_ind, num_shards)


def _toyworld(shard_ind: int, num_shards: int, split: str = "train",
              image_size: int = 64):
    from hma_tpu_torch.data.extern.toyworld import toyworld_episode_generator

    return toyworld_episode_generator(shard_ind, num_shards, split=split,
                                      image_size=image_size)


DATASET_TO_GEN_AND_SIZE: dict[str, tuple[Callable, int]] = {
    "ego4d": (_ego4d, 1000),
    "exoego4d": (_egoexo4d, 1000),
    "robomimic": (_robomimic, 200),
    "epic_kitchen": (_epic_kitchen, 700),  # unregistered in the reference
    # procedural action-conditioned world (no external data; the
    # dynamics-generalization probe — see extern/toyworld.py)
    "toyworld": (_toyworld, 480),
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Encode an extern dataset shard")
    p.add_argument("--dataset_name", type=str, required=True,
                   choices=sorted(DATASET_TO_GEN_AND_SIZE))
    p.add_argument("--data_split", type=str, default="train")
    p.add_argument("--shard_ind", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--encoder_type", type=str, default="magvit",
                   choices=["magvit", "raw"])
    p.add_argument("--encoder_name_or_path", type=str, default="data/magvit2.ckpt")
    p.add_argument("--out_root", type=str, default="data")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=256,
                   help="frame resize target (reference hardcodes 256; "
                        "the toyworld probe runs at 64)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    gen_factory, _ = DATASET_TO_GEN_AND_SIZE[args.dataset_name]
    if args.dataset_name == "toyworld":
        episodes = gen_factory(args.shard_ind, args.num_shards,
                               split=args.data_split,
                               image_size=args.image_size)
    else:
        episodes = gen_factory(args.shard_ind, args.num_shards)
    encode_batch = None
    suffix = "raw"
    if args.encoder_type == "magvit":
        from hma_tpu_torch.tokenizer.convert import load_magvit2

        encode_batch = make_magvit_encoder(
            *load_magvit2(args.encoder_name_or_path),
            batch_size=args.batch_size, device=device)
        suffix = "magvit"

    out_dir = SHARD_DATA_FORMAT.format(root=args.out_root, name=args.dataset_name,
                                       suffix=suffix, i=args.shard_ind, n=args.num_shards,
                                       split=args.data_split)
    meta = encode_episodes(episodes, out_dir, args.dataset_name,
                           encode_batch=encode_batch,
                           image_size=args.image_size)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
