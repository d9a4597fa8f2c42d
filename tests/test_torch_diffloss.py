"""Port DiffLoss.sample vs hma_tpu's on a small head, fp32 on the CPU, with
the JAX draws handed in: plain and domain-stacked head, premodulated and
direct, with and without classifier-free guidance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hma_tpu.models.diffloss import DiffLoss as JaxDiffLoss
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.diffusion.gaussian import p_sample_loop_indexed
from hma_tpu_torch.models.diffloss import DiffLoss, premod_phases
from torch_port_helpers import jax_sampler_draws, perturbed

C, Z, DEPTH, WIDTH, K, N = 5, 12, 2, 128, 10, 6
TOL = dict(atol=1e-5, rtol=1e-4)  # the JAX kernel test's own limits


def _kw(num_domains: int) -> dict:
    return dict(target_channels=C, z_channels=Z, depth=DEPTH, width=WIDTH,
                num_sampling_steps=str(K), num_domains=num_domains)


@functools.lru_cache(maxsize=None)
def _jax_head(num_domains: int, seed: int):
    """(jax head, params, z) of `build`, made once a (num_domains, seed):
    the init is jitted (eager flax runs it op by op)."""
    jm = JaxDiffLoss(**_kw(num_domains), dtype=jnp.float32, loop_kernel=False)
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(N, C)).astype(np.float32)
    z = rng.normal(size=(N, Z)).astype(np.float32)
    dom = None if num_domains == 0 else jnp.asarray(1, jnp.int32)
    params = jax.jit(lambda k, kd: jm.init({"params": k, "diffusion": kd}, target, z, None,
                                           dom, method=JaxDiffLoss.loss))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    return jm, perturbed(params, rng, 0.05), z


def build(num_domains: int, seed: int = 0):
    """(jax head, params, port head, z (N, Z) numpy), every parameter
    perturbed: the adaLN and final linears are zero at init. The port head
    is new at each call."""
    jm, params, z = _jax_head(num_domains, seed)
    tm = DiffLoss(**_kw(num_domains), dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(params, None))
    return jm, params, tm, z


@pytest.mark.parametrize("num_domains", [0, 3])
@pytest.mark.parametrize("cfg,temp,clip", [(1.0, 1.0, True), (1.0, 0.8, False),
                                           (2.0, 1.0, True)])
@pytest.mark.parametrize("premod", [True, False])
def test_sample_matches_jax(num_domains, cfg, temp, clip, premod):
    jm, params, tm, z = build(num_domains)
    zz = np.concatenate([z, 0.5 * z]) if cfg != 1.0 else z
    dom = None if num_domains == 0 else 1
    key = jax.random.PRNGKey(5)
    want = jm.apply(params, jnp.asarray(zz), key, temp, cfg, clip,
                    None if dom is None else jnp.asarray(dom, jnp.int32), premod,
                    method=JaxDiffLoss.sample)
    noise, zs = jax_sampler_draws(key, K, zz.shape[0], C, cfg)
    got = tm.sample(torch.from_numpy(zz), None, temp, cfg, clip, dom, premod,
                    noise=torch.from_numpy(noise), zs=torch.from_numpy(zs))
    assert tuple(got.shape) == (zz.shape[0], C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("num_domains", [0, 3])
@pytest.mark.parametrize("cfg", [1.0, 2.0])
def test_premod_equals_direct_in_the_port(num_domains, cfg):
    """The fused loop's plain version, the premodulated phases run step by
    step (`residual` under `p_sample_loop_indexed`) and the direct sampler
    give the same samples from one generator seed."""
    _, _, tm, z = build(num_domains, seed=1)
    zz = torch.from_numpy(np.concatenate([z, 0.5 * z]) if cfg != 1.0 else z)
    dom = None if num_domains == 0 else 2
    gen = lambda: torch.Generator().manual_seed(11)
    fused = tm.sample(zz, gen(), 0.9, cfg, True, dom, premod=True)
    direct = tm.sample(zz, gen(), 0.9, cfg, True, dom, premod=False)
    np.testing.assert_allclose(fused.numpy(), direct.numpy(), **TOL)
    if cfg == 1.0:
        precompute, residual = premod_phases(tm.net, dom)
        mods = precompute(torch.from_numpy(tm.gen_sched.timestep_map), zz)
        g = gen()
        noise = torch.randn(zz.shape[0], C, generator=g)
        stepwise = p_sample_loop_indexed(
            lambda x, idx: residual(x, {"blocks": [m[idx] for m in mods["blocks"]],
                                        "final": mods["final"][idx]}),
            tm.gen_sched, noise, g, temperature=0.9, clip_denoised=True)
        np.testing.assert_allclose(stepwise.numpy(), direct.numpy(), **TOL)


def test_cfg_halves_share_noise_and_eps():
    """Under cfg both halves start from one noise and take one mixed eps:
    at temperature 0 (no per-row variance term) they stay identical."""
    _, _, tm, z = build(0, seed=2)
    zz = torch.from_numpy(np.concatenate([z, 0.5 * z]))
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32))
    half = rng.normal(size=(K, N, C)).astype(np.float32)
    zs = torch.from_numpy(np.concatenate([half, half], axis=1))
    out = tm.sample(zz, None, 0.0, 2.0, True, noise=noise, zs=zs)
    assert torch.equal(out[:N], out[N:])
    warm = tm.sample(zz, None, 1.0, 2.0, True, noise=noise, zs=zs)
    assert not torch.equal(warm[:N], warm[N:])  # v, and so the variance, is per row
    with pytest.raises(ValueError, match="noise must be"):
        tm.sample(zz, None, 1.0, 2.0, True, noise=torch.cat([noise, noise]), zs=zs)


def test_loss_is_not_ported_and_says_where():
    """The training loss runs (held to hma_tpu's in
    tests/test_torch_stmar_train.py): its draws repeat with the generator's
    seed, and rows of mask 0 do not count."""
    _, _, tm, z = build(0)
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    zz = torch.from_numpy(z)
    with torch.no_grad():
        a, b = (tm.loss(target, zz, mask, generator=torch.Generator().manual_seed(1))
                for _ in range(2))
        moved = target.clone()
        moved[mask == 0] += 5.0
        c = tm.loss(moved, zz, mask, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a) and a.item() == b.item() == c.item()


def test_reset_parameters_zeroes_adaln_and_final_like_jax():
    tm = DiffLoss(C, Z, DEPTH, WIDTH, str(K), dtype=torch.float32, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    for name, w in sd.items():
        zero = "adaLN" in name or "final_linear" in name or name.endswith("bias")
        if "_ln." in name:
            continue
        assert bool((w == 0).all()) == zero, name
    out = tm.sample(torch.zeros(4, Z), torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("num_domains", [0, 3])
def test_loop_inputs_are_kept_until_the_weights_change(num_domains):
    """The sampler keeps its per-domain weights for the fused loop between
    calls and makes them anew once a parameter was written to."""
    _, _, src, z = build(num_domains, seed=3)
    tm = DiffLoss(C, Z, DEPTH, WIDTH, str(K), num_domains=num_domains,
                  dtype=torch.bfloat16, device="cpu")  # bf16: the kept weights are copies
    tm.load_state_dict(src.state_dict())
    dom = None if num_domains == 0 else 1
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    draws = dict(noise=torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)),
                 zs=torch.from_numpy(rng.normal(size=(K, N, C)).astype(np.float32)))
    zz = torch.from_numpy(z)
    first = tm.sample(zz, None, 1.0, 1.0, True, dom, **draws)
    kept = tm._loop_kernel_inputs(dom, dev)
    assert tm._loop_kernel_inputs(dom, dev)[0] is kept[0]
    assert torch.equal(tm.sample(zz, None, 1.0, 1.0, True, dom, **draws), first)
    with torch.no_grad():
        for p in tm.net.parameters():
            p.mul_(1.25)
    assert tm._loop_kernel_inputs(dom, dev)[0] is not kept[0]
    fresh = DiffLoss(C, Z, DEPTH, WIDTH, str(K), num_domains=num_domains,
                     dtype=torch.bfloat16, device="cpu")
    fresh.load_state_dict(tm.state_dict())
    second = tm.sample(zz, None, 1.0, 1.0, True, dom, **draws)
    assert not torch.equal(second, first)
    assert torch.equal(second, fresh.sample(zz, None, 1.0, 1.0, True, dom, **draws))
