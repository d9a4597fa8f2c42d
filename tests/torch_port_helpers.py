"""Shared set-up for the tests/test_torch_*.py files: one tiny discrete and
one tiny continuous card built in both packages, JAX weights converted into
the port, the JAX rollouts' random draws rebuilt as arrays, and the JAX
training forwards' draws (dropout masks, diffusion timesteps and noise,
action masks) recorded to hand to the port.

Importing this module sets torch to one intra-op thread for the whole
process (see below), so every test process that imports it, every port test
under pytest-xdist among them, runs torch's CPU ops and the plain references
it compares against on one thread."""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.ops.diffusion_sampler import pregenerate_noises as jax_pregenerate_noises
from hma_tpu.rollout.mar import mar_subset_schedule as jax_mar_subset_schedule
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT

# One intra-op thread for torch in every test process. Under pytest-xdist
# each worker collects the whole suite, so this import reaches every worker;
# six workers each running torch's thread pool at one thread a core
# oversubscribe the cores six times over, and the port's CPU training tests
# then spend most of their time waiting (test_resume_equals_straight_run,
# six workers on 8 cores: 58.5 s with a thread a core, 1.8 s with one).
torch.set_num_threads(1)


def tiny_card(qk_norm: bool = False,
              action_network: str = "concat+modulate", **kw) -> dict:
    """2 layers, 2 heads, d 32, T 4, S 16, 8 concat action tokens,
    1 domain (as tests/test_rollout.py); `kw` overrides any field, the
    width and heads (`d_model`, `num_heads`) among them."""
    card = dict(num_layers=2, num_heads=2, d_model=32, T=4, S=16,
                image_vocab_size=2**18, num_factored_vocabs=2,
                action_token_size=8, action_network=action_network,
                use_actions=True, action_domains=["a"], d_actions=[4],
                action_stats=[[[0.1, -0.2], [1.5, 0.5]]], qk_norm=qk_norm)
    card.update(kw)
    return card


def _once_a_process(build):
    """`build(**kw)` -> (jax_model, jax_params, port card, *arrays), made
    once a set of arguments in a process (the jitted init is most of a
    pair's cost, and several test files build the same pair); each call
    returns copies of the arrays and a new port model loaded with the
    params, so no caller sees another's changes."""
    cache = {}

    @functools.wraps(build)
    def wrapper(model_cls, **kw):
        key = json.dumps(kw, sort_keys=True, default=str)
        if key not in cache:
            cache[key] = build(**kw)
        jm, params, cfg, *arrays = cache[key]
        tm = model_cls(copy.deepcopy(cfg), dtype=torch.float32, device="cpu")
        tm.load_state_dict(params_from_jax(params, cfg))
        return (jm, jax.tree.map(np.array, params), tm, *(np.array(a) for a in arrays))

    return wrapper


def build_pair(qk_norm: bool = False, B: int = 2, seed: int = 0,
               action_network: str = "concat+modulate", **card_kw):
    """(jax_model, jax_params, torch_model, tokens, actions) in fp32.

    The init is jitted (eager flax init takes several times longer on the
    CPU). Every parameter is perturbed with noise after init so that zero-init
    tensors (positional embedding, biases, mask tokens) are exercised by
    the conversion too. tokens (B, T, S) int32 with some mask ids;
    actions (B, T, max_d_action) float32. Made once a process for each set
    of arguments (`_once_a_process`)."""
    return _jax_pair(STMaskGIT, qk_norm=qk_norm, B=B, seed=seed,
                     action_network=action_network, **card_kw)


@_once_a_process
def _jax_pair(qk_norm, B, seed, action_network, **card_kw):
    card = tiny_card(qk_norm, action_network, **card_kw)
    jcfg = JaxGenieConfig(**card)
    jm = JaxSTMaskGIT(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.image_vocab_size,
                          (B, jcfg.T, jcfg.S)).astype(np.int32)
    tokens[:, -1, ::3] = jcfg.image_vocab_size
    actions = rng.normal(size=(B, jcfg.T, jcfg.max_d_action)).astype(np.float32)
    # "action_drop" is drawn only by joint cards' init (no parameter reads it)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed),
                               "action_drop": jax.random.PRNGKey(seed)}, tokens, tokens,
                              actions, jnp.asarray(0, jnp.int32))
    return jm, perturbed(params, rng), GenieConfig(**card), tokens, actions


def to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu" else x)


def jax_unmask_draws(key, frames: int, B: int, S: int, steps: int = 2) -> np.ndarray:
    """The "random"-mode uniforms of hma_tpu's per-frame rollouts,
    (frames, steps, B, S): one key per frame (split of `key`), one per step
    (split of the frame's key), and the second half of each step key's split
    feeds the uniforms (rollout/maskgit.py:106,89-95 and :178-181,
    :229,211-216)."""
    out = np.zeros((frames, steps, B, S), np.float32)
    for i, k_frame in enumerate(jax.random.split(key, frames)):
        out[i] = jax_horizon_draws(k_frame, steps, B, S)
    return out


def jax_horizon_draws(key, steps: int, B: int, n: int) -> np.ndarray:
    """The "random"-mode uniforms of one hma_tpu MaskGIT refinement over n
    tokens a row, (steps, B, n): one key per step (split of `key`), the
    second half of its split feeding the uniforms; `generate_horizon` draws
    them so over its H*S tokens (rollout/maskgit.py:397-420)."""
    out = np.zeros((steps, B, n), np.float32)
    for j, k_step in enumerate(jax.random.split(key, steps)):
        _, k_conf = jax.random.split(k_step)
        out[j] = np.asarray(jax.random.uniform(k_conf, (B, n)))
    return out


def tiny_mar_card(**kw) -> dict:
    """The tiny continuous card: 2 layers, 2 heads, d 32, T 4, 4x4x4 latents
    in 2x2 patches (4 patch tokens of dim 16) + 8 concat action tokens, 1
    domain, head depth 2 x width 128 (the denoise-loop kernel wants a
    multiple of 128), 4 sampling steps, 3 MaskGIT steps."""
    card = dict(num_layers=2, num_heads=2, d_model=32, T=4, S=16,
                image_vocab_size=2**18, num_factored_vocabs=2, vae_embed_dim=4,
                patch_size=2, diffloss_d=2, diffloss_w=128, num_sampling_steps="4",
                maskgit_steps=3, action_token_size=8,
                action_network="concat+modulate", use_actions=True,
                jointly_predict_actions=False, action_domains=["a"], d_actions=[4],
                action_stats=[[[0.1, -0.2], [1.5, 0.5]]], qk_norm=False)
    card.update(kw)
    return card


def perturbed(params, rng, scale: float = 0.02):
    """Every leaf plus noise, so that zero-init tensors (positional
    embeddings, mask tokens, every adaLN and final_linear) take part."""
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.normal(size=x.shape).astype(np.float32),
        params)


def port_model(cls, card: dict, seed: int = 0, scale: float = 0.02):
    """The port's model alone (`STMaskGIT` or `STMAR`) of `card` in fp32 on
    the CPU, drawn from `seed`, every parameter plus noise as `perturbed`
    adds it (the zero-init tensors take part): for tests that compare the
    port with itself and need no JAX side, so no JAX init is compiled."""
    cfg_cls = DiffusionGenieConfig if cls is STMAR else GenieConfig
    model = cls(cfg_cls(**card), dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return model


def build_mar_pair(B: int = 2, seed: int = 0, **card_kw):
    """(jax_model, jax_params, torch_model, latents, actions) in fp32 for
    the tiny continuous card; latents (B, T, h, w, C), actions (B, T,
    max_d_action), both float32 numpy. The init is jitted; every parameter
    is perturbed after it. Made once a process for each set of arguments."""
    return _jax_mar_pair(STMAR, B=B, seed=seed, **card_kw)


@_once_a_process
def _jax_mar_pair(B, seed, **card_kw):
    card = tiny_mar_card(**card_kw)
    jcfg = JaxDiffusionGenieConfig(**card)
    jm = JaxSTMAR(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    h = jcfg.h
    lat = rng.normal(size=(B, jcfg.T, h, h, jcfg.vae_embed_dim)).astype(np.float32)
    actions = rng.normal(size=(B, jcfg.T, jcfg.max_d_action)).astype(np.float32)
    mask = np.zeros((B, jcfg.T, h, h), np.int32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed),
                               "diffusion": jax.random.PRNGKey(seed + 1),
                               "action_drop": jax.random.PRNGKey(seed + 2)},
                              lat, lat, actions, jnp.asarray(0, jnp.int32), mask)
    return jm, perturbed(params, rng), DiffusionGenieConfig(**card), lat, actions


def jax_sampler_draws(k_s, K: int, rows: int, C: int, cfg: float = 1.0):
    """The draws of one `hma_tpu` DiffLoss.sample(z, k_s) call as numpy:
    (start noise (rows or rows/2, C), zs (K, rows, C) in loop order):
    noise = normal(k_s), then fold_in(k_s, 1) and one split per denoise
    step (models/diffloss.py:434-441, diffusion/gaussian.py:328-333)."""
    n = rows // 2 if cfg != 1.0 else rows
    noise = np.array(jax.random.normal(k_s, (n, C), jnp.float32))
    zs = np.array(jax_pregenerate_noises(jax.random.fold_in(k_s, 1), K, rows, C))
    return noise, zs


def jax_mar_draws(key, frames: int, B: int, S: int, steps: int, K: int, C: int,
                  cfg: float = 1.0, compat: str = "mar") -> dict:
    """The draws of an `hma_tpu` MAR rollout over `frames` generated frames
    as the port's `draws` dict of tensors. B is the batch the engine runs
    (doubled under cfg). One key per frame (split of `key`,
    rollout/mar.py:231), each frame's draws as `jax_mar_frame_draws`."""
    per = [jax_mar_frame_draws(k, B, S, steps, K, C, cfg, compat)
           for k in jax.random.split(key, frames)]
    return {k: torch.stack([d[k] for d in per]) for k in per[0]}


def jax_mar_frame_draws(k_frame, B: int, S: int, steps: int, K: int, C: int,
                        cfg: float = 1.0, compat: str = "mar") -> dict:
    """The draws of one `hma_tpu` `generate_frame_mar` call with key
    `k_frame`, as the port's per-frame `draws`: k_order = split(key) and the
    orders from split(k_order, B or B/2) (rollout/mar.py:106, :121-126); per
    step key, k_s = split(key) (:138), and k_s feeds `jax_sampler_draws`."""
    _, counts = jax_mar_subset_schedule(S, steps, compat=compat)
    rows = B * max(counts)
    k, k_order = jax.random.split(k_frame)
    n_orders = B // 2 if cfg != 1.0 else B
    orders = np.stack([np.asarray(jax.random.permutation(ko, S))
                       for ko in jax.random.split(k_order, n_orders)])
    noise, zs = [], []
    for _ in range(steps):
        k, k_s = jax.random.split(k)
        a, b = jax_sampler_draws(k_s, K, rows, C, cfg)
        noise.append(a)
        zs.append(b)
    return {"orders": torch.from_numpy(orders.astype(np.int64)),
            "noise": torch.from_numpy(np.stack(noise)),
            "zs": torch.from_numpy(np.stack(zs))}


class JaxTrainingDraws:
    """Record the random draws of `hma_tpu` training forwards traced or run
    inside the `with` block (not under remat), to hand them to the port:

    - `dropout`: every `nn.Dropout` mask in call order, drawn as flax draws
      it (one `make_rng` per call, bernoulli(keep)): two per STBlock, after
      the MLP's GELU and after its fc2;
    - `action_masks`: the `action_mask` each STMAR.compute_latents received;
    - `diffusion`: (t, noise) of each `training_losses` call (the noise
      rebuilt from its key as the function draws it).

    Under jit the records are tracers: return `rec.tree()` from the jitted
    function and rebuild with `JaxTrainingDraws.of(tree)` outside it.
    `masks` and `draws` give them in the port's formats."""

    def __init__(self, tree=None):
        tree = tree or {"dropout": [], "action_masks": [], "diffusion": []}
        self.dropout = tree["dropout"]
        self.action_masks = tree["action_masks"]
        self.diffusion = tree["diffusion"]

    def tree(self) -> dict:
        return {"dropout": self.dropout, "action_masks": self.action_masks,
                "diffusion": self.diffusion}

    @classmethod
    def of(cls, tree) -> "JaxTrainingDraws":
        return cls(jax.tree.map(np.asarray, tree))

    def __enter__(self):
        import flax.linen as nn

        from hma_tpu.models import diffloss as jax_diffloss
        from hma_tpu.models.st_mar import STMAR as JaxSTMAR

        def intercept(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
                x, deterministic = args[0], kwargs.get(
                    "deterministic", args[1] if len(args) > 1 else None)
                if deterministic or mod.rate == 0.0:
                    return next_fun(*args, **kwargs)
                rng = mod.make_rng(mod.rng_collection)
                self.dropout.append(jax.random.bernoulli(rng, 1.0 - mod.rate, x.shape))
                return next_fun(x, deterministic, rng=rng)
            if isinstance(mod, JaxSTMAR) and context.method_name == "compute_latents":
                am = args[3] if len(args) > 3 else kwargs.get("action_mask")
                self.action_masks.append(am)
            return next_fun(*args, **kwargs)

        original = jax_diffloss.training_losses

        def recording(net_apply, sched, x0, t, cond, key, channel_mask=None):
            self.diffusion.append((t, jax.random.normal(key, x0.shape, x0.dtype)))
            return original(net_apply, sched, x0, t, cond, key, channel_mask)

        self._restore = (jax_diffloss, original)
        jax_diffloss.training_losses = recording
        self._ctx = nn.intercept_methods(intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        module, original = self._restore
        module.training_losses = original

    def masks(self, start: int, layers: int) -> list:
        """The port's `dropout` for `layers` blocks from mask `start` on."""
        m = [torch.from_numpy(np.array(x)) for x in self.dropout[start:start + 2 * layers]]
        return [(m[2 * i], m[2 * i + 1]) for i in range(layers)]

    def draws(self, i: int = 0, layers: int = 0) -> dict:
        """STMAR forward i, trained with `layers` blocks of dropout (0: none
        recorded), as the port's `draws`."""
        def t_(x):
            return torch.from_numpy(np.array(x))

        am = self.action_masks[i]
        heads = len(self.diffusion) // len(self.action_masks)
        t, noise = self.diffusion[i * heads]
        out = {"t": t_(t).long(), "noise": t_(noise)}
        if am is not None:
            T = am.shape[1]
            out["action_t0"] = t_(T - np.asarray(am).reshape(am.shape[0], T).sum(1)).long()
            if heads > 1:
                t, noise = self.diffusion[i * heads + 1]
                out.update(action_t=t_(t).long(), action_noise=t_(noise))
        if layers:
            out["dropout"] = self.masks(2 * layers * i, layers)
        return out


def port_names(shapes, cfg) -> list:
    """The port's parameter name of each leaf of a JAX param tree (or of
    its `jax.eval_shape`), in `jax.tree.leaves` order, through
    `params_from_jax`'s name map: leaf i is filled with i and read back."""
    leaves, treedef = jax.tree.flatten(shapes)
    coded = jax.tree.unflatten(treedef, [np.full(np.shape(x), i, np.float32)
                                         for i, x in enumerate(leaves)])
    names = [None] * len(leaves)
    for name, arr in params_from_jax(coded, cfg).items():
        names[int(arr.reshape(-1)[0])] = name
    return names


def jax_tree_from_port(tensors: dict, shapes, cfg):
    """Port tensors {name: tensor} (parameters, grads or moments) as a JAX
    tree shaped like `shapes` (numpy fp32; Dense weights transposed back to
    kernels)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for name, (path, s) in zip(port_names(shapes, cfg), paths):
        x = tensors[name].detach().float().cpu().numpy()
        dense = getattr(path[-1], "key", None) == "kernel" and len(np.shape(s)) == 2
        out.append(x.T if dense else x)
    return jax.tree.unflatten(treedef, out)
