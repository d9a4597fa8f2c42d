"""Merge encoded shard directories into one dataset (counterpart of
hma_tpu/data/merge_shards.py; host numpy, byte for byte its output).

Rebuild of datasets/merge_shards.py: concatenates `video.bin` /
`actions/actions.bin` across shards, re-offsets `segment_ids` so episode
ids stay monotonically increasing, and tolerates missing shards
(reference: merge_shards.py:16-113, :30-39).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

SHARD_DATA_FORMAT = "{root}/{name}_{suffix}_shard{i}_of_{n}_{split}"


def merge_shards(shard_dirs: list[str], out_dir: str) -> dict:
    metas, videos, segs, acts = [], [], [], []
    seg_offset = 0
    for d in shard_dirs:
        d = Path(d)
        meta_path = d / "metadata.json"
        if not meta_path.exists() or (d / "error.json").exists():
            print(f"skipping missing/empty shard {d}")
            continue
        meta = json.loads(meta_path.read_text())
        dtype = np.dtype(meta.get("token_dtype", "uint32"))
        if meta.get("latent_channels"):
            # continuous VAE latents: float16 (N, C, h, w)
            shape = (meta["num_images"], meta["latent_channels"],
                     meta["h"], meta["w"])
        elif dtype == np.uint8 and meta.get("vocab_size") is None:
            shape = (meta["num_images"], meta["h"], meta["w"], 3)
        else:
            shape = (meta["num_images"], meta["h"], meta["w"])
        video = np.memmap(d / "video.bin", dtype=dtype, mode="r", shape=shape)
        seg = np.memmap(d / "segment_ids.bin", dtype=np.int32, mode="r",
                        shape=(meta["num_images"],))
        videos.append(np.asarray(video))
        segs.append(np.asarray(seg) + seg_offset)
        seg_offset = int(segs[-1].max()) + 1 if len(segs[-1]) else seg_offset
        act_path = d / "actions" / "actions.bin"
        if act_path.exists():
            acts.append(np.memmap(act_path, dtype=np.float32, mode="r"
                                  ).reshape(meta["num_images"], -1))
        metas.append(meta)

    if not metas:
        raise FileNotFoundError("no valid shards to merge")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    video = np.concatenate(videos)
    video.tofile(out / "video.bin")
    np.concatenate(segs).tofile(out / "segment_ids.bin")
    if acts:
        (out / "actions").mkdir(exist_ok=True)
        np.concatenate(acts).tofile(out / "actions" / "actions.bin")
    meta = dict(metas[0])
    meta["num_images"] = int(video.shape[0])
    meta["num_episodes"] = sum(m.get("num_episodes", 0) for m in metas)
    with open(out / "metadata.json", "w") as f:
        json.dump(meta, f)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description="Merge encoded dataset shards")
    p.add_argument("--dataset_name", type=str, required=True)
    p.add_argument("--suffix", type=str, default="magvit")
    p.add_argument("--data_split", type=str, default="train")
    p.add_argument("--num_shards", type=int, required=True)
    p.add_argument("--root", type=str, default="data")
    p.add_argument("--out_dir", type=str, default=None)
    args = p.parse_args(argv)

    shard_dirs = [SHARD_DATA_FORMAT.format(root=args.root, name=args.dataset_name,
                                           suffix=args.suffix, i=i,
                                           n=args.num_shards, split=args.data_split)
                  for i in range(args.num_shards)]
    out_dir = args.out_dir or (f"{args.root}/{args.dataset_name}_{args.suffix}"
                               f"_max1000000_{args.data_split}")
    meta = merge_shards(shard_dirs, out_dir)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
