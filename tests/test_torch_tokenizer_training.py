"""The port's tokenizer GAN training against hma_tpu's, on the CPU in fp32:
every loss function, the discriminator (logits in training and evaluation
mode, running statistics after the real -> fake chain, which pins flax's
biased variance), the VQConfig sidecar both ways, and one and three GAN
steps at tests/test_tokenizer.py's small codec (32², B 2) from the same
weights (JAX's init, perturbed, carried across by `params_from_flax` /
`disc_params_from_flax`): with the VGG LPIPS and the adaptive GAN weight
(`gen_loss_weight` None), and without LPIPS and the entropy term at the
fixed weight 0.1. Each JAX step is compiled once per module."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from hma_tpu.metrics.lpips import LPIPS as JaxLPIPS
from hma_tpu.metrics.lpips import load_lpips_torch_weights as jax_load_lpips
from hma_tpu.tokenizer import losses as jl
from hma_tpu.tokenizer.convert import torch_state_dict_to_flax as jax_torch_to_flax
from hma_tpu.tokenizer.discriminator import NLayerDiscriminator as JaxDisc
from hma_tpu.tokenizer.magvit2 import VQConfig as JaxVQConfig
from hma_tpu.tokenizer.magvit2 import VQModel as JaxVQModel
from hma_tpu.tokenizer.train_vq import VQTrainState as JaxVQTrainState
from hma_tpu.tokenizer.train_vq import make_vq_train_step as jax_make_step
from hma_tpu.tokenizer.train_vq import warmup_schedule as jax_warmup
from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights
from hma_tpu_torch.tokenizer import losses as tl
from hma_tpu_torch.tokenizer.convert import disc_params_from_flax, params_from_flax
from hma_tpu_torch.tokenizer.discriminator import NLayerDiscriminator
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.tokenizer.train_vq import (
    ema_decay,
    init_vq_train_state,
    make_vq_train_step,
    warmup_cosine_schedule,
)

SMALL = dict(base_channels=32, ch_mult=(1, 2), num_res_blocks=1, disc_ndf=16,
             disc_num_layers=2)
LOSS_TOL = 1e-6     # each loss function on the same logits, relative
DISC_TOL = 1e-5     # discriminator logits and running statistics, relative to max
# The two GAN-step cases. The entropy term's per-bit sigmoid(4 z / 0.01)
# multiplies the two packages' rounding differences in the latents by up to
# 100, so with its default weight (0.1) the generator's gradients agree to
# ~1e-3 of each tensor's largest (readings: 1.1e-3 at step 1, 2.0e-3 at step
# 3); with it off they agree to ~1e-5 (readings 4.7e-6, 1.3e-5).
# The parameters are held as STEP_TOL below says.
LR, WARMUP = 1e-5, 2
CASES = {"lpips_adaptive": dict(lpips=True, gen_loss_weight=None, moment_tol=5e-3,
                                param_atol=2 * LR),
         "plain_fixed": dict(lpips=False, gen_loss_weight=0.1, codebook_weight=0.0,
                             moment_tol=5e-5, param_atol=1e-6)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max|d|/max|x| {err:.3e} > {tol}"


# --------------------------------------------------------------- losses

@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla", "non_saturate"])
def test_losses_match_jax(disc_loss):
    rng = np.random.default_rng(0)
    lr, lf = (rng.normal(size=(2, 1, 3, 3)).astype(np.float32) for _ in range(2))
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    _close(tl.D_LOSSES[disc_loss](t(lr), t(lf)), jl.D_LOSSES[disc_loss](j(lr), j(lf)),
           LOSS_TOL, disc_loss)
    _close(tl.non_saturate_gen_loss(t(lf)), jl.non_saturate_gen_loss(j(lf)), LOSS_TOL, "gen")
    for step, thr in ((3, 5), (5, 5), (9, 5)):
        assert np.float32(tl.adopt_weight(0.7, step, thr)) == jl.adopt_weight(
            0.7, jnp.asarray(step), thr)
    state_t = tl.LeCamState(torch.tensor(0.3), torch.tensor(-0.2))
    state_j = jl.LeCamState(jnp.asarray(0.3), jnp.asarray(-0.2))
    upd_t, upd_j = tl.lecam_update(state_t, t(lr), t(lf)), jl.lecam_update(state_j, j(lr), j(lf))
    for a, b in zip(upd_t, upd_j):
        _close(a, b, LOSS_TOL, "lecam_update")
    _close(tl.lecam_reg(t(lr), t(lf), upd_t), jl.lecam_reg(j(lr), j(lf), upd_j), LOSS_TOL,
           "lecam_reg")
    for n, g in ((2.0, 0.5), (1e-9, 3.0), (5.0, 0.0)):
        _close(tl.adaptive_gan_weight(torch.tensor(n), torch.tensor(g), 0.8),
               jl.adaptive_gan_weight(jnp.asarray(n), jnp.asarray(g), 0.8), LOSS_TOL, "adaptive")

    cfg_t = VQConfig(disc_loss=disc_loss, disc_start=4)
    cfg_j = JaxVQConfig(disc_loss=disc_loss, disc_start=4)
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    fake_lpips = (lambda a, b: (a - b).mean(axis=(1, 2, 3)) ** 2)  # any (B,) function
    for step in (3, 4):
        for lp in (None, fake_lpips):
            got, glogs = tl.generator_loss(
                _nchw(x), _nchw(r), torch.tensor(-0.5), torch.tensor(0.25), t(lf),
                lpips_fn=lp and (lambda a, b: fake_lpips(a.permute(0, 2, 3, 1),
                                                         b.permute(0, 2, 3, 1))),
                global_step=step, config=cfg_t, d_weight=torch.tensor(0.3))
            want, wlogs = jl.generator_loss(
                j(x), j(r), jnp.asarray(-0.5), jnp.asarray(0.25), j(lf), lpips_fn=lp,
                global_step=jnp.asarray(step), config=cfg_j, d_weight=jnp.asarray(0.3))
            assert set(glogs) == set(wlogs)
            for k in wlogs:
                _close(glogs[k], wlogs[k], LOSS_TOL, f"generator_loss {k}")
        got, lecam_t, dlogs = tl.discriminator_loss(t(lr), t(lf), state_t, global_step=step,
                                                    config=cfg_t)
        want, lecam_j, wlogs = jl.discriminator_loss(j(lr), j(lf), state_j,
                                                     global_step=jnp.asarray(step), config=cfg_j)
        assert set(dlogs) == set(wlogs)
        for k in wlogs:
            _close(dlogs[k], wlogs[k], LOSS_TOL, f"discriminator_loss {k}")
        for a, b in zip(lecam_t, lecam_j):
            _close(a, b, LOSS_TOL, "discriminator_loss lecam")


def test_schedules_and_ema_decay_match_jax():
    from hma_tpu.tokenizer import train_vq as jvq
    from hma_tpu_torch.tokenizer.train_vq import warmup_schedule

    for step in (0, 3, 9, 10, 40, 99):
        _close(warmup_schedule(2e-4, 10)(step), jvq.warmup_schedule(2e-4, 10)(step), 1e-6, "wu")
        _close(warmup_cosine_schedule(2e-4, 10, 100)(step),
               jvq.warmup_cosine_schedule(2e-4, 10, 100)(jnp.asarray(step, jnp.float32)),
               1e-6, "cos")
        assert ema_decay(step) == np.float32(jvq.ema_decay(jnp.asarray(step, jnp.float32)))


# -------------------------------------------------------- discriminator

@pytest.fixture(scope="module")
def disc_pair():
    """hma_tpu's discriminator (3 layers, ndf 16) from its own init, every
    variable perturbed (the running statistics away from 0 and 1), and the
    port's carrying the same values; inputs at 32²."""
    jd = JaxDisc(ndf=16, n_layers=3)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = jax.jit(lambda k: jd.init(k, x, train=True))(jax.random.PRNGKey(1))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    td = NLayerDiscriminator(ndf=16, n_layers=3, device="cpu")
    missing, unexpected = td.load_state_dict(disc_params_from_flax(variables, 3), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return jd, variables, td, x, rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def test_discriminator_layout():
    sd = NLayerDiscriminator(device="cpu").state_dict()
    assert sd["main.0.weight"].shape == (64, 3, 4, 4) and "main.0.bias" in sd
    assert "main.2.bias" not in sd and sd["main.3.running_var"].shape == (128,)
    assert sd["main.8.weight"].shape == (512, 256, 4, 4) and sd["main.11.weight"].shape == (
        1, 512, 4, 4)
    x = jnp.zeros((1, 32, 32, 3))
    want = jax.jit(lambda k: JaxDisc().init(k, x, train=True))(jax.random.PRNGKey(0))
    assert sum(v.numel() for k, v in sd.items() if "running" not in k
               and "num_batches" not in k) == sum(
        a.size for a in jax.tree_util.tree_leaves(want["params"]))


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_logits_match_jax(disc_pair, train):
    jd, variables, td, x, _ = disc_pair
    want = jd.apply(variables, x, train=train, mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    td.train(train)
    with torch.no_grad():
        got = td(_nchw(x))
    td.load_state_dict(disc_params_from_flax(variables, 3), strict=False)  # undo the stats
    assert got.shape == (2, 1, 2, 2)
    _close(got.permute(0, 2, 3, 1).numpy(), want, DISC_TOL, f"logits train={train}")


def test_discriminator_running_stats_after_real_then_fake_match_jax(disc_pair):
    jd, variables, td, x, y = disc_pair
    _, stats = jd.apply(variables, x, train=True, mutable=["batch_stats"])
    _, stats = jd.apply({**variables, **stats}, y, train=True, mutable=["batch_stats"])
    td.train()
    with torch.no_grad():
        td(_nchw(x))
        td(_nchw(y))
    got = td.state_dict()
    want = disc_params_from_flax({"batch_stats": stats["batch_stats"]}, 3)
    assert len(want) == 6
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), DISC_TOL, k)
    # the control: torch's own BatchNorm2d update (toward the unbiased
    # variance) on the same values must miss the limit
    td.load_state_dict(disc_params_from_flax(variables, 3), strict=False)
    for bn in td.main:
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.forward = functools.partial(torch.nn.BatchNorm2d.forward, bn)
    try:
        with torch.no_grad():
            td(_nchw(x))
            td(_nchw(y))
        ctl = td.state_dict()
    finally:
        for bn in td.main:
            bn.__dict__.pop("forward", None)
        td.load_state_dict(disc_params_from_flax(variables, 3), strict=False)
    ctl_err = max(np.abs(ctl[k].numpy() - v.numpy()).max() / np.abs(v.numpy()).max()
                  for k, v in want.items() if k.endswith("running_var"))
    assert ctl_err > 10 * DISC_TOL


def test_vq_config_sidecar_loads_both_ways(tmp_path):
    """The port keeps a subset of hma_tpu's fields, with the same defaults;
    each package drops the other's unknown keys."""
    kept = {f.name for f in dataclasses.fields(VQConfig)}
    assert kept < {f.name for f in dataclasses.fields(JaxVQConfig)}
    port = VQConfig(gen_loss_weight=None, disc_start=7, ch_mult=(1, 2))
    port.save_pretrained(tmp_path / "port.json")
    back = dataclasses.asdict(JaxVQConfig.from_pretrained(tmp_path / "port.json"))
    want = dataclasses.asdict(JaxVQConfig())
    want.update(dataclasses.asdict(port))
    assert back == want
    jax_cfg = JaxVQConfig(lecam_loss_weight=0.01, pixelloss_weight=2.0, codebook_size=512)
    jax_cfg.save_pretrained(tmp_path / "jax.json")
    assert dataclasses.asdict(VQConfig.from_pretrained(tmp_path / "jax.json")) == {
        k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in kept}
    assert dataclasses.asdict(VQConfig()) == {
        k: v for k, v in dataclasses.asdict(JaxVQConfig()).items() if k in kept}
    assert json.loads((tmp_path / "port.json").read_text())["gen_loss_weight"] is None


# ------------------------------------------------------------ GAN steps

# One and three steps, fp32 on the CPU in both packages, at a small lr (a
# larger one lets near-zero latents change sign between the packages within
# three steps, after which the runs part). Relative to the value (logs) or
# to each tensor's largest (the running statistics and LeCam EMAs:
# STEP_TOL; readings up to 3.2e-5), and the Adam moments (each case's
# `moment_tol`). The parameters and their EMA: Adam's first step moves an
# element by lr times the sign of its gradient whatever the gradient's size,
# so where a gradient is ~0 the two packages may move it up to 2 lr apart a
# step. With the entropy term (lpips_adaptive) its `param_atol` of 2 lr a
# step therefore cannot fail (reading 0.96 lr) and checks nothing; without
# it (plain_fixed) the gradients agree closely and 0.1 lr a step holds
# (reading 0.017 lr). After the first step, in both cases, the elements
# whose first moment exceeds twice `moment_tol` of its tensor's largest (the
# moment limit fixes the gradient's sign there) are held to
# MASKED_PARAM_TOL (readings 0.012 lr, the parameters' rounding).
STEP_TOL = 1e-4
MASKED_PARAM_TOL = 0.05 * LR


def _lpips_state():
    return {k: v.clone() for k, v in LPIPS(
        "vgg", device="cpu", generator=torch.Generator().manual_seed(5)).state_dict().items()}


@functools.lru_cache(maxsize=None)
def _start_weights():
    """Both cases' starting weights as JAX trees: the port's small codec
    from a seed, every tensor perturbed, through hma_tpu's own importer
    (`torch_state_dict_to_flax`; a flax init would take seconds to
    compile), and hma_tpu's discriminator init (2 layers, ndf 16) with every
    variable perturbed and the running statistics away from 0 and 1."""
    rng = np.random.default_rng(3)
    codec = VQModel(VQConfig(**SMALL), dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    gen = jax_torch_to_flax({k: v.numpy() + 0.02 * rng.normal(size=v.shape).astype(np.float32)
                             for k, v in codec.state_dict().items()})
    disc = JaxDisc(ndf=SMALL["disc_ndf"], n_layers=SMALL["disc_num_layers"])
    dvars = jax.jit(lambda k: disc.init(k, jnp.zeros((1, 32, 32, 3)), train=True))(
        jax.random.PRNGKey(3))
    dvars = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), dvars)
    dvars["batch_stats"] = jax.tree.map(np.abs, dvars["batch_stats"])
    return gen, dvars


@pytest.fixture(scope="module", params=list(CASES))
def gan_run(request):
    case = dict(CASES[request.param])
    tols = case.pop("moment_tol"), case.pop("param_atol")
    return tols, _gan_run(**case)


def _gan_run(lpips, gen_loss_weight, lr=LR, **cfg):
    """Both packages from the same weights, three steps on three batches;
    the states after step 1 and step 3 in the port's layout."""
    cfg_j = JaxVQConfig(**SMALL, disc_start=0, gen_loss_weight=gen_loss_weight, **cfg)
    cfg_t = VQConfig(**SMALL, disc_start=0, gen_loss_weight=gen_loss_weight, **cfg)
    rng = np.random.default_rng(3)
    gen, dvars = _start_weights()
    vq, disc = JaxVQModel(cfg_j, dtype=jnp.float32), JaxDisc(ndf=cfg_j.disc_ndf,
                                                           n_layers=cfg_j.disc_num_layers)
    tx_g, tx_d = (optax.adam(jax_warmup(lr, WARMUP), b1=0.5, b2=0.9) for _ in range(2))
    js = JaxVQTrainState(gen, jax.jit(tx_g.init)(gen), dvars,
                         jax.jit(tx_d.init)(dvars["params"]), gen,
                         jnp.zeros(()), jl.LeCamState.init(), jnp.zeros((), jnp.int32))

    lp_sd = _lpips_state() if lpips else None
    jax_lpips = None
    if lp_sd is not None:
        lp_params = jax_load_lpips(JaxLPIPS(net="vgg"), {k: v.numpy() for k, v in lp_sd.items()})
        jax_lpips = lambda a, b: JaxLPIPS(net="vgg").apply(lp_params, a, b)  # noqa: E731
    jstep = jax.jit(jax_make_step(vq, disc, tx_g, tx_d, cfg_j, lpips_fn=jax_lpips))

    ts = init_vq_train_state(cfg_t, 0, lr=lr, warmup_steps=WARMUP, device="cpu")
    ts.gen.load_state_dict(params_from_flax(gen))
    ts.ema = {k: v.clone() for k, v in ts.gen.state_dict().items()}
    ts.disc.load_state_dict(disc_params_from_flax(dvars, SMALL["disc_num_layers"]),
                            strict=False)
    lpips = None if lp_sd is None else load_lpips_torch_weights(LPIPS("vgg", device="cpu"),
                                                                lp_sd)
    tstep = make_vq_train_step(ts, cfg_t, lpips_fn=lpips)

    out = {}
    for i in range(3):
        images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        js, jlogs = jstep(js, jnp.asarray(images))
        tlogs = tstep(_nchw(images))
        if i in (0, 2):
            out[i + 1] = (_port_view(ts, tlogs), _jax_view(js, jlogs))
    return out


def _port_view(ts, logs):
    return {"logs": {k: float(v) for k, v in logs.items()},
            "gen": {k: v.numpy().copy() for k, v in ts.gen.state_dict().items()},
            "ema": {k: v.numpy().copy() for k, v in ts.ema.items()},
            "disc": {k: v.numpy().copy() for k, v in ts.disc.state_dict().items()
                     if "num_batches" not in k},
            "gen_m": {k: v.numpy().copy() for k, v in ts.gen_opt.m.items()},
            "gen_v": {k: v.numpy().copy() for k, v in ts.gen_opt.v.items()},
            "disc_m": {k: v.numpy().copy() for k, v in ts.disc_opt.m.items()},
            "lecam": [float(ts.lecam.real_ema), float(ts.lecam.fake_ema)],
            "step": ts.step, "ema_updates": ts.ema_updates}


def _jax_view(js, logs):
    n = SMALL["disc_num_layers"]
    np_ = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    return {"logs": {k: float(v) for k, v in logs.items()},
            "gen": np_(params_from_flax(js.gen_params)),
            "ema": np_(params_from_flax(js.ema_params)),
            "disc": np_(disc_params_from_flax(jax.tree.map(np.asarray, js.disc_vars), n)),
            "gen_m": np_(params_from_flax(js.gen_opt[0].mu)),
            "gen_v": np_(params_from_flax(js.gen_opt[0].nu)),
            "disc_m": np_(disc_params_from_flax({"params": js.disc_opt[0].mu}, n)),
            "lecam": [float(js.lecam.real_ema), float(js.lecam.fake_ema)],
            "step": int(js.step), "ema_updates": int(js.ema_updates)}


@pytest.mark.parametrize("steps", [1, 3])
def test_gan_steps_match_jax(gan_run, steps):
    (moment_tol, param_atol), runs = gan_run
    got, want = runs[steps]
    assert got["step"] == want["step"] == steps and got["ema_updates"] == steps
    assert set(got["logs"]) == set(want["logs"])
    for k, v in want["logs"].items():
        _close(got["logs"][k], v, STEP_TOL, f"step {steps} log {k}")
    _close(got["lecam"], want["lecam"], STEP_TOL, "LeCam EMAs")
    for group in ("gen_m", "gen_v", "disc_m"):
        assert set(got[group]) == set(want[group])
        for k in want[group]:
            _close(got[group][k], want[group][k], moment_tol, f"step {steps} {group} {k}")
    assert set(got["disc"]) == set(want["disc"])
    for group in ("gen", "ema", "disc"):
        for k in want[group]:
            a, b = got[group][k], want[group][k]
            if "running" in k:
                _close(a, b, STEP_TOL, f"step {steps} {k}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=param_atol * steps,
                                           err_msg=f"step {steps} {group} {k}")
                if steps == 1:
                    m = np.abs(want["disc_m" if group == "disc" else "gen_m"][k])
                    held = m > 2 * moment_tol * m.max()
                    np.testing.assert_allclose(a[held], b[held], rtol=0, atol=MASKED_PARAM_TOL,
                                               err_msg=f"step 1 {group} {k}, where held")
