"""The port's MagVit2/LFQ tokenizer against hma_tpu's, on the CPU in fp32:
LFQ exactly, depth-to-space exactly, the codec in both weight directions
(the port's state dict through hma_tpu's own importer into JAX, and a JAX
tree through `params_from_flax` into the port) to 1e-4 of max|z|, the
default config's state dict in the reference checkpoint's key layout,
`load_magvit2` on a `.ckpt` written here (sidecar config, EMA shadows), and
the token decoder and image encoder built from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.data.encode_openx import make_magvit_encoder as jax_make_magvit_encoder
from hma_tpu.rollout.decode import make_token_decoder as jax_make_token_decoder
from hma_tpu.tokenizer import image_ops as jax_image_ops
from hma_tpu.tokenizer import lfq as jax_lfq
from hma_tpu.tokenizer.convert import _torch_to_flax_name, torch_state_dict_to_flax
from hma_tpu.tokenizer.convert import load_magvit2 as jax_load_magvit2
from hma_tpu.tokenizer.magvit2 import VQConfig as JaxVQConfig
from hma_tpu.tokenizer.magvit2 import VQModel as JaxVQModel
from hma_tpu.tokenizer.magvit2 import depth_to_space as jax_depth_to_space
from hma_tpu_torch.data.encode_openx import make_magvit_encoder
from hma_tpu_torch.rollout.decode import load_svd_decoder, make_feature_decoder, make_token_decoder
from hma_tpu_torch.tokenizer import image_ops
from hma_tpu_torch.tokenizer.convert import load_magvit2, params_from_flax
from hma_tpu_torch.tokenizer.lfq import (
    bits_to_indices,
    codes_to_latents,
    indices_to_bits,
    lfq_quantize,
)
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel, depth_to_space

SMALL = dict(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
TOL = 1e-4  # of max|z| (latents) and max|x| (decoded images), fp32 on both sides


def _jax_model():
    return JaxVQModel(JaxVQConfig(**SMALL), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_fns():
    """One jitted JAX encoder and decoder for the small config, shared by
    every test (the weights are arguments)."""
    jm = _jax_model()
    enc = jax.jit(lambda p, im: jm.apply(p, im, method=JaxVQModel.encode_without_quantize))
    dec = jax.jit(lambda p, idx: jm.apply(p, idx, method=JaxVQModel.decode_code))
    return enc, dec


def _images(rng, n=2, size=32):
    return rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _perturbed_port_model(seed):
    """The small port codec from `seed`, every tensor plus noise (GroupNorm
    scales and the zero biases take part)."""
    model = VQModel(VQConfig(**SMALL), dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    model.load_state_dict({k: v + torch.from_numpy(0.02 * rng.normal(size=v.shape)).float()
                           for k, v in model.state_dict().items()})
    return model.eval()


def _perturbed_jax_params(seed):
    rng = np.random.default_rng(seed)
    params = jax.jit(_jax_model().init)(jax.random.PRNGKey(seed), _images(rng, 1))
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)


def _assert_tokens_match(got, want, z, margin=1e-4):
    """Token grids equal wherever every channel's |z| exceeds `margin`."""
    sure = np.abs(z).min(axis=-1) > margin
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(got)[sure], np.asarray(want)[sure])


def test_lfq_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, 4, 4, 18)).astype(np.float32) * 0.1
    z[0, 0, 0, :3] = 0.0  # exact zeros quantize to -1 in both
    got = lfq_quantize(torch.from_numpy(z), compute_losses=True)
    want = jax_lfq.lfq_quantize(jnp.asarray(z), compute_losses=True)
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.quantized.numpy(), np.asarray(want.quantized))
    for k in ("entropy_loss", "commit_loss", "per_sample_entropy", "codebook_entropy"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6)
    ids = rng.integers(0, 2**18, (3, 5)).astype(np.int32)
    bits = indices_to_bits(torch.from_numpy(ids), 18)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax_lfq.indices_to_bits(ids, 18)))
    np.testing.assert_array_equal(bits_to_indices(bits).numpy(), ids)
    np.testing.assert_array_equal(
        codes_to_latents(torch.from_numpy(ids), 18, torch.float32).numpy(),
        np.asarray(jax_lfq.codes_to_latents(ids, 18, jnp.float32)))
    # straight-through: d sum(quantized) / dz is all ones
    zt = torch.from_numpy(z).requires_grad_()
    lfq_quantize(zt).quantized.sum().backward()
    np.testing.assert_array_equal(zt.grad.numpy(), np.ones_like(z))
    with pytest.raises(ValueError, match="int32"):
        bits_to_indices(torch.zeros(2, 32, dtype=torch.bool))


def test_depth_to_space_and_image_ops_match_jax():
    x = np.arange(2 * 12 * 3 * 5, dtype=np.float32).reshape(2, 12, 3, 5)  # NCHW
    got = depth_to_space(torch.from_numpy(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_depth_to_space(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)))
    img = np.random.default_rng(1).integers(0, 256, (6, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(image_ops.center_crop_to_square(img),
                                  jax_image_ops.center_crop_to_square(img))
    norm = image_ops.normalize_image_np(img)
    np.testing.assert_array_equal(norm, jax_image_ops.normalize_image_np(img))
    np.testing.assert_array_equal(image_ops.unnormalize_image_np(norm),
                                  jax_image_ops.unnormalize_image_np(norm))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_codec_matches_jax(jax_fns, direction):
    enc, dec = jax_fns
    if direction == "port_to_jax":
        model = _perturbed_port_model(3)
        params = torch_state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    else:
        params = _perturbed_jax_params(4)
        model = VQModel(VQConfig(**SMALL), dtype=torch.float32, device="cpu").eval()
        model.load_state_dict(params_from_flax(params))
    rng = np.random.default_rng(5)
    x = _images(rng)
    want_z = np.asarray(enc(params, x))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        z = model.encode_without_quantize(xt).permute(0, 2, 3, 1).numpy()
        res = model.encode(xt)
    scale = np.abs(want_z).max()
    assert np.abs(z - want_z).max() <= TOL * scale
    _assert_tokens_match(res.indices, jax_lfq.lfq_quantize(jnp.asarray(want_z)).indices, want_z)
    assert res.quantized.shape == (2, 18, 16, 16)
    ids = rng.integers(0, 2**18, (2, 16, 16)).astype(np.int32)
    want = np.asarray(dec(params, ids))
    with torch.no_grad():
        got = model.decode_code(torch.from_numpy(ids)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_default_config_is_the_reference_key_layout():
    """Every key of the released architecture's state dict goes through
    hma_tpu's importer to the JAX model's parameter shapes (no conv runs)."""
    sd = VQModel(VQConfig(), dtype=torch.float32, device="meta").state_dict()
    got = {}
    for name, value in sd.items():
        mapped = _torch_to_flax_name(name)
        assert mapped is not None, name
        path, kind = mapped
        shape = tuple(value.shape)
        got[path] = (shape[2], shape[3], shape[1], shape[0]) if kind == "conv" else shape
    tree = jax.eval_shape(JaxVQModel(JaxVQConfig()).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3), jnp.float32))["params"]
    want = {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    assert sum(v.numel() for v in sd.values()) == 65_490_709  # 65.5M, as hma_tpu's


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-layout `.ckpt` of the small codec: the weights under
    `state_dict`, different EMA shadows that must win, quantizer and
    loss-net keys to ignore, and the `<ckpt>.json` sidecar."""
    root = tmp_path_factory.mktemp("magvit2")
    live, ema = _perturbed_port_model(6), _perturbed_port_model(7)
    state = {**live.state_dict(),
             **{f"model_ema.{k.replace('.', '')}": v for k, v in ema.state_dict().items()},
             "model_ema.num_updates": torch.tensor(3), "model_ema.decay": torch.tensor(0.999),
             "quantize.codebook": torch.zeros(4), "loss.discriminator.w": torch.ones(2)}
    path = root / "magvit2.ckpt"
    torch.save({"state_dict": state, "global_step": 3}, path)
    VQConfig(**SMALL).save_pretrained(str(path) + ".json")
    return path, ema


def test_load_magvit2_decoder_and_encoder_match_jax(ckpt):
    path, ema = ckpt
    state, cfg = load_magvit2(str(path))
    assert cfg == VQConfig(**SMALL)
    assert state.keys() == ema.state_dict().keys()
    assert all(torch.equal(state[k], v) for k, v in ema.state_dict().items())
    jax_params, jax_cfg = jax_load_magvit2(str(path))
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 2**18, (5, 16, 16)).astype(np.uint32)
    got = make_token_decoder(state, cfg, batch_size=4, device="cpu")(ids)
    want = jax_make_token_decoder(jax_params, jax_cfg, batch_size=4, dtype=jnp.float32)(ids)
    assert got.dtype == np.uint8 and got.shape == want.shape == (5, 32, 32, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99

    frames = rng.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    encode = make_magvit_encoder(state, cfg, batch_size=4, device="cpu")
    jax_encode = jax_make_magvit_encoder(jax_params, jax_cfg, batch_size=4, dtype=jnp.float32)
    tokens = encode(frames)
    assert tokens.dtype == np.uint32 and encode.vocab_size == 2**18
    jm = JaxVQModel(jax_cfg, dtype=jnp.float32)
    z = np.asarray(jax.jit(lambda p, im: jm.apply(p, im, method=JaxVQModel.encode_without_quantize))(
        jax_params, image_ops.normalize_image_np(frames)))
    _assert_tokens_match(tokens, jax_encode(frames), z)


def test_load_magvit2_refuses(ckpt, tmp_path):
    path, _ = ckpt
    with pytest.raises(FileNotFoundError, match="magvit2.ckpt"):
        load_magvit2(str(tmp_path / "missing.ckpt"))
    with pytest.raises(FileNotFoundError, match="no tokenizer checkpoint"):
        load_magvit2(str(tmp_path))  # a directory without train_tokenizer's tags
    state = torch.load(path, weights_only=False)["state_dict"]
    bad = tmp_path / "bad.ckpt"
    torch.save({k: v for k, v in state.items() if k != "decoder.conv_out.bias"}, bad)
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        load_magvit2(str(bad), use_ema=False)  # and the default config does not fit
    with pytest.raises(FileNotFoundError, match="vae.pt"):
        load_svd_decoder(str(tmp_path / "vae.pt"), device="cpu")


def test_feature_decoder_clamps_raw_latents():
    seen = []

    def fake_vae(z):
        seen.append(z)
        return z[:, :3].transpose(0, 2, 3, 1)

    lat = np.full((3, 4, 2, 2), 10.0, np.float32)
    out = make_feature_decoder(fake_vae, batch_size=2, clamp=25.0)(lat)
    assert [len(z) for z in seen] == [2, 1] and out.shape == (3, 2, 2, 3)
    np.testing.assert_allclose(out, 25.0)  # 10 / SVD_SCALE ~ 54.9, clamped
