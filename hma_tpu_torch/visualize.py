"""Visualization CLI: `python -m hma_tpu_torch.visualize` (counterpart of
hma_tpu/visualize.py).

Reads the `video.bin` + `metadata.json` that `generate` writes (per
example: prompt | prediction | ground truth frames), decodes each example's
frames to uint8 pixels and writes an animated GIF (prompt then prediction,
captioned) and a comic-strip PNG (Prompt|Generated over Prompt|Ground-truth)
per example. Token streams decode through the MagVit2 codec
(`tokenizer.convert.load_magvit2` + `rollout.decode.make_token_decoder`;
`--tokenizer_ckpt` a `.ckpt` or a `train_tokenizer` directory); latent
streams (`latent_channels` in the metadata, written by `generate
--use_feature`) through the SVD temporal VAE (`rollout.decode.
load_svd_decoder`; `--tokenizer_ckpt` its state-dict file), each example
one clip, the raw latents clamped to +/-25. The flags are hma_tpu's plus
`--device` (default: the CUDA card; raises without one).

The decode (`decode_examples`) is apart from the rendering: Pillow is
imported only where a file is written.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

from hma_tpu_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize generated token videos")
    p.add_argument("--token_dir", type=str, required=True,
                   help="directory with video.bin + metadata.json from generate.py")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--tokenizer_ckpt", type=str, default="data/magvit2.ckpt")
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--max_examples", type=int, default=8)
    p.add_argument("--offset", type=int, default=0,
                   help="first example index to render")
    p.add_argument("--disable_comic", action="store_true",
                   help="skip the comic-strip PNGs")
    p.add_argument("--stride", type=int, default=1,
                   help="only 1: hma_tpu takes the flag and reads it nowhere")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without a card)")
    args = p.parse_args(argv)
    if args.stride != 1:
        p.error(f"--stride {args.stride}: only 1 is supported")
    return args


def make_latent_frame_decoder(vae_checkpoint: str, device=None) -> Callable:
    """(N, h, w, C) raw SVD-VAE latents -> (N, 8h, 8w, 3) uint8 frames,
    decoded as one clip, the latents clamped to +/-25."""
    from hma_tpu_torch.rollout.decode import load_svd_decoder

    dec = load_svd_decoder(vae_checkpoint, device=device)

    def decode(lat_nhwc: np.ndarray) -> np.ndarray:
        z = np.clip(lat_nhwc, -25.0, 25.0).astype(np.float32)[None]  # (1, N, h, w, C)
        img = dec(z)[0]  # (N, H, W, 3) in [-1, 1]
        return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)

    return decode


def load_stream(token_dir: Path, tokenizer_ckpt: str, device=None):
    """(video, decode, metadata) of a generate output: (N, h, w) tokens
    with the codec's decoder, or (N, h, w, C) latents with the VAE's."""
    meta = json.loads((token_dir / "metadata.json").read_text())
    h, w = meta["h"], meta["w"]
    if "latent_channels" in meta:
        C = meta["latent_channels"]
        video = np.fromfile(token_dir / "video.bin", dtype=np.float16) \
            .reshape(-1, C, h, w).transpose(0, 2, 3, 1)
        return video, make_latent_frame_decoder(tokenizer_ckpt, device), meta
    from hma_tpu_torch.rollout.decode import make_token_decoder
    from hma_tpu_torch.tokenizer.convert import load_magvit2

    video = np.fromfile(token_dir / "video.bin",
                        dtype=np.dtype(meta.get("token_dtype", "uint32"))).reshape(-1, h, w)
    return video, make_token_decoder(*load_magvit2(tokenizer_ckpt), device=device), meta


def decode_examples(args) -> Iterator[tuple[int, np.ndarray, int, int]]:
    """(i, frames (n_prompt + 2 gen, H, W, 3) uint8, n_prompt, gen) for the
    examples from `args.offset`, at most `args.max_examples` of them."""
    device = resolve_device(args.device)
    video, decode, meta = load_stream(Path(args.token_dir), args.tokenizer_ckpt, device)
    n_prompt = meta["num_prompt_frames"]
    gen = meta["window_size"] - n_prompt
    per_ex = n_prompt + 2 * gen  # prompt | pred | gt
    n_ex = min(len(video) // per_ex, args.offset + args.max_examples)
    for i in range(args.offset, n_ex):
        yield i, decode(video[i * per_ex:(i + 1) * per_ex]), n_prompt, gen


def caption_image(img, text: str):
    """The frame under a 16-pixel black banner holding `text`."""
    from PIL import Image, ImageDraw

    w, h = img.size
    banner = Image.new("RGB", (w, 16), (0, 0, 0))
    ImageDraw.Draw(banner).text((2, 2), text, fill=(255, 255, 255))
    out = Image.new("RGB", (w, h + 16))
    out.paste(banner, (0, 0))
    out.paste(img, (0, 16))
    return out


def export_to_gif(frames: list, path: str, fps: int = 2) -> None:
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def comic_strip(rows: list, labels: list[str]):
    """Rows of frames side by side, one captioned row per sequence."""
    from PIL import Image

    w, h = rows[0][0].size
    ncol = max(len(r) for r in rows)
    out = Image.new("RGB", (ncol * w, len(rows) * (h + 16)), (20, 20, 20))
    for ri, (row, label) in enumerate(zip(rows, labels)):
        for ci, img in enumerate(row):
            out.paste(caption_image(img, label if ci == 0 else ""), (ci * w, ri * (h + 16)))
    return out


def main(argv=None):
    args = parse_args(argv)
    out_dir = Path(args.output_dir or Path(args.token_dir) / "vis")
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for i, px, n_prompt, gen in decode_examples(args):
        from PIL import Image

        imgs = [Image.fromarray(f) for f in px]
        prompt, pred, gt = imgs[:n_prompt], imgs[n_prompt:n_prompt + gen], imgs[n_prompt + gen:]
        export_to_gif([caption_image(f, "Prompt") for f in prompt]
                      + [caption_image(f, "Generated") for f in pred],
                      str(out_dir / f"example_{i}.gif"), args.fps)
        if not args.disable_comic:
            comic_strip([prompt + pred, prompt + gt],
                        ["Prompt|Generated", "Prompt|Ground-truth"]).save(
                out_dir / f"example_{i}_comic.png")
        n += 1
    print(f"wrote {n} examples to {out_dir}")


if __name__ == "__main__":
    main()
