"""The resident temporal layout (`temporal_layout="resident"`) against
hma_tpu, on the CPU: K5''s plain version against the Pallas entry
`fused_temporal_attention_kl` in interpret mode (forward and gradients, fp32
and bf16), `SelfAttention.temporal_resident` against JAX's (forward and
gradients, qk_norm both ways), and, in the port, resident against transpose
for STMaskGIT and STMAR (forward and gradients, qk_norm both ways), with
the limits of JAX's own test (tests/test_st_maskgit.py:177-200). K5' itself
is held to this plain version on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py).

Tolerances: fp32 2e-5 (summation order only); bf16 at most 1 % of the
outputs may differ from the Pallas kernel at all, as the K3' test allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models import attention as jax_attention
from hma_tpu.ops import temporal_attention as jax_ta
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.attention import SelfAttention
from hma_tpu_torch.models.st_mar import STMAR, patchify
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.ops.temporal_attention import (
    FusedTemporalResident,
    temporal_resident_bwd_plain,
    temporal_resident_plain,
)
from torch_port_helpers import tiny_card, tiny_mar_card

TOL = dict(atol=2e-5, rtol=2e-5)
SHAPE = (2, 5, 64, 2, 32)  # (B, T, S, H, D): B*S = 128 sites, one Pallas tile


def _kl(x, dtype):
    """(B, T, S, H, D) numpy -> the TPU kernel's (H, T, D, B*S)."""
    B, T, S, H, D = x.shape
    return jnp.asarray(x, dtype).transpose(3, 1, 4, 0, 2).reshape(H, T, D, B * S)


def _from_kl(x, shape):
    B, T, S, H, D = shape
    return np.asarray(jnp.asarray(x, jnp.float32).reshape(H, T, D, B, S)
                      .transpose(3, 1, 4, 0, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_plain_matches_pallas_kl_entry(dtype):
    """out and dq, dk, dv of `temporal_resident_plain` /
    `temporal_resident_bwd_plain` against `fused_temporal_attention_kl`
    (interpret mode) and its custom VJP."""
    rng = np.random.default_rng(0)
    q = (0.3 * rng.normal(size=SHAPE)).astype(np.float32)
    k, v, dout = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_kl, vjp = jax.vjp(lambda a, b, c: jax_ta.fused_temporal_attention_kl(a, b, c, True),
                          _kl(q, jdt), _kl(k, jdt), _kl(v, jdt))
    want = _from_kl(out_kl, SHAPE)
    want_grads = [_from_kl(g, SHAPE) for g in vjp(_kl(dout, jdt))]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, dout))
    out, lse = temporal_resident_plain(tq, tk, tv)
    grads = temporal_resident_bwd_plain(tq, tk, tv, out, lse, tdo).unbind(3)
    assert out.dtype == tdt and out.is_contiguous() and out.shape == SHAPE
    for name, got, w in [("out", out, want)] + list(zip(("dq", "dk", "dv"), grads, want_grads)):
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, w, **TOL, err_msg=name)
        else:
            share = (got != w).mean()
            assert share <= 0.01, f"{name}: {share:.4%} of the bf16 outputs differ"


@pytest.mark.parametrize("qk_norm", [False, True])
def test_temporal_resident_matches_jax(qk_norm):
    """The attention module's resident pass: output and the gradients of
    its parameters and of its input against JAX's (which, off the TPU,
    regroups and attends in XLA)."""
    B, T, S, H, D = 2, 4, 6, 2, 16
    jmod = jax_attention.SelfAttention(num_heads=H, d_model=H * D, qk_norm=qk_norm,
                                       use_mup=False, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, S, H * D)).astype(np.float32)
    g = rng.normal(size=(B, T, S, H * D)).astype(np.float32)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        jmod.init(jax.random.PRNGKey(0), x[:, 0]))
    want, vjp = jax.vjp(lambda p, xx: jmod.apply(
        p, xx, method=jax_attention.SelfAttention.temporal_resident), params, x)
    want_p, want_x = vjp(g)
    tmod = SelfAttention(H, H * D, qk_norm=qk_norm, use_mup=False, dtype=torch.float32,
                         device="cpu")
    tmod.load_state_dict(params_from_jax(params, None))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tmod.temporal_resident(tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    for n, w in params_from_jax(want_p, None).items():
        np.testing.assert_allclose(dict(tmod.named_parameters())[n].grad.numpy(), w.numpy(),
                                   **TOL, err_msg=n)


def _perturbed(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # wake the zero-init tensors (tokens, heads, adaLN)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return model


def _family(name, qk_norm):
    """(model class, config, full forward, training loss) of a tiny card."""
    rng = np.random.default_rng(2)
    if name == "discrete":
        cfg = GenieConfig(**tiny_card(qk_norm))
        tokens = torch.from_numpy(rng.integers(0, cfg.image_vocab_size, (2, cfg.T, cfg.S)))
        inp = tokens.clone()
        inp[:, 1:, ::2] = cfg.image_vocab_size
        acts = torch.from_numpy(rng.normal(size=(2, cfg.T, 4)).astype(np.float32))
        return (STMaskGIT, cfg, lambda m: m.compute_logits(inp, acts, 0)[0],
                lambda m: m(inp, tokens, acts, 0)["loss"])
    cfg = DiffusionGenieConfig(**tiny_mar_card(qk_norm=qk_norm, jointly_predict_actions=True))
    lat = torch.from_numpy(rng.normal(size=(2, cfg.T, 4, 4, 4)).astype(np.float32))
    acts = torch.from_numpy(rng.normal(size=(2, cfg.T, 4)).astype(np.float32))
    mask = torch.from_numpy((rng.random((2, cfg.T, 4, 4)) < 0.5).astype(np.int32))
    draws = {"action_t0": torch.tensor([1, 2]), "t": torch.arange(32) * 31,
             "noise": torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)),
             "action_t": torch.arange(8) * 97,
             "action_noise": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))}

    def loss(m):
        out = m(lat, lat, acts, 0, mask, draws=draws)
        return out["loss"] + out["action_loss"]

    return (STMAR, cfg, lambda m: m.compute_latents(patchify(lat, 2), acts, 0)[0], loss)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_resident_equals_transpose_in_the_port(family, qk_norm):
    cls, cfg, forward, loss = _family(family, qk_norm)
    base = _perturbed(cls(cfg, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0)), 1)
    outs, grads = [], []
    for layout in ("transpose", "resident"):
        model = cls(cfg, dtype=torch.float32, device="cpu", temporal_layout=layout)
        model.load_state_dict(base.state_dict())
        with torch.no_grad():
            outs.append(forward(model))
        loss(model).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=2e-5, rtol=1e-5)
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for n in grads[0]:
        np.testing.assert_allclose(grads[1][n].numpy(), grads[0][n].numpy(),
                                   atol=5e-5, rtol=5e-4, err_msg=n)


def test_resident_function_hands_qkv_one_gradient():
    """`FusedTemporalResident`'s backward gives the projection's (B, T, S,
    3, H, D) gradient as one contiguous tensor, its q slot scaled; with
    q and k handed in (qk_norm) their slots go to them and are zero in it."""
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 3, 5, 3, 2, 32, generator=g, requires_grad=True)
    FusedTemporalResident.apply(qkv, 0.5).square().sum().backward()
    ref = qkv.detach().clone().requires_grad_(True)
    q, k, v = ref.unbind(3)
    out, _ = temporal_resident_plain(q * 0.5, k, v)
    out.square().sum().backward()
    # K4''s plain formula (through delta = dout . out) against autograd's
    # softmax backward: the same function summed in another order
    assert qkv.grad.is_contiguous()
    torch.testing.assert_close(qkv.grad, ref.grad, atol=1e-4, rtol=1e-4)
    qkv.grad = None
    qn, kn = (x.detach().clone().requires_grad_(True) for x in qkv.unbind(3)[:2])
    FusedTemporalResident.apply(qkv, 0.5, qn, kn).square().sum().backward()
    assert not qkv.grad[..., :2, :, :].any()
    for got, want in ((qkv.grad[..., 2, :, :], ref.grad[..., 2, :, :]),
                      (qn.grad, ref.grad[..., 0, :, :]), (kn.grad, ref.grad[..., 1, :, :])):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
