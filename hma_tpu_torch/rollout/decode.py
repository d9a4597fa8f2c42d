"""Batch token/latent -> pixel decoding for evaluation and the simulator
(counterpart of hma_tpu/rollout/decode.py): the MagVit2 decoder for discrete
tokens (`make_token_decoder`), the SVD temporal VAE's decoder for continuous
latents (`load_svd_decoder`), its clips of dataset latents as uint8 pixels
(`decode_clips`) and the clip-and-scale wrapper of such a decode
(`make_feature_decoder`)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from hma_tpu_torch import resolve_device
from hma_tpu_torch.data.datasets import SVD_SCALE
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel, unnormalize_image
from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE


def codec(state_dict_or_model: Union[dict, VQModel], config: Optional[VQConfig] = None,
          dtype=None, device=None) -> VQModel:
    """A VQModel in eval mode: the one given, or one built on `device` (the
    CUDA card unless told otherwise) in `dtype` (bf16 on the card, fp32 on
    the CPU) and loaded from the state dict."""
    if isinstance(state_dict_or_model, VQModel):
        return state_dict_or_model.eval()
    device = resolve_device(device)
    dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
    model = VQModel(config or VQConfig(), dtype=dtype, device=device)
    model.load_state_dict(state_dict_or_model)
    return model.eval()


def make_token_decoder(state_dict_or_model: Union[dict, VQModel],
                       config: Optional[VQConfig] = None, batch_size: int = 16,
                       dtype=None, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Returns decode(tokens (N, h, w) ints, numpy or a tensor) -> (N, H, W,
    3) uint8 numpy, in batches of `batch_size` on the codec's device."""
    model = codec(state_dict_or_model, config, dtype, device)
    device = next(model.parameters()).device

    @torch.no_grad()
    def decode(tokens) -> np.ndarray:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens.astype(np.int32))
        tokens = tokens.to(device)
        out = []
        for i in range(math.ceil(len(tokens) / batch_size)):
            img = model.decode_code(tokens[i * batch_size:(i + 1) * batch_size])
            out.append(unnormalize_image(img).permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.uint8)

    return decode


def load_svd_decoder(vae_checkpoint: str, dtype=None, device=None) -> Callable:
    """A diffusers AutoencoderKLTemporalDecoder state-dict file (the released
    architecture, `SVDTemporalVAE()`) -> decode(latents) taking (B, T, h, w,
    C) RAW (not x SVD_SCALE) latents, numpy or a tensor, and returning (B, T,
    8h, 8w, 3) in [-1, 1] as fp32 numpy. The VAE is built on `device` (the
    CUDA card unless told otherwise) in `dtype` (bf16 on the card, fp32 on
    the CPU); keys under `loss` and `ema` are dropped, as `hma_tpu`'s
    importer drops them, and any other key that does not fit raises."""
    device = resolve_device(device)
    dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
    state = torch.load(vae_checkpoint, map_location="cpu")
    vae = SVDTemporalVAE(dtype=dtype, device=device).eval()
    vae.load_state_dict({k: v for k, v in state.items() if not k.startswith(("loss", "ema"))})

    @torch.no_grad()
    def decode(latents) -> np.ndarray:
        return vae.decode(torch.as_tensor(latents).to(device)).float().cpu().numpy()

    return decode


def decode_clips(decode: Callable, latents: np.ndarray, clamp: float = 25.0) -> np.ndarray:
    """(B, T, h, w, C) x SVD_SCALE latents -> (B, T, 8h, 8w, 3) uint8, one
    clip a call of `decode` (a `load_svd_decoder` function), the RAW
    (unscaled) latents clamped to +/-`clamp`."""
    img = np.concatenate([decode(np.clip(latents[i:i + 1] / SVD_SCALE, -clamp, clamp)
                                 .astype(np.float32)) for i in range(len(latents))])
    return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)


def make_feature_decoder(vae_decode_fn: Callable, batch_size: int = 16,
                         clamp: float = 25.0) -> Callable[[np.ndarray], np.ndarray]:
    """Continuous path: latents (N, C, h, w), scaled by SVD_SCALE in the
    dataset, divided back and the RAW values clamped to ±clamp (as the
    reference clamps unscaled latents), then decoded by `vae_decode_fn`."""

    def decode(latents: np.ndarray) -> np.ndarray:
        out = []
        for i in range(math.ceil(len(latents) / batch_size)):
            shard = np.asarray(latents[i * batch_size:(i + 1) * batch_size], np.float32)
            out.append(np.asarray(vae_decode_fn(np.clip(shard / SVD_SCALE, -clamp, clamp))))
        if not out:
            return np.zeros((0, 0, 0, 3), np.uint8)
        return np.concatenate(out)

    return decode
