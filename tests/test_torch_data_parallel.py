"""Data parallelism over processes (the mesh's "dp" axis), port vs hma_tpu on
the CPU: two gloo ranks, launched once for the module as subprocesses with
torchrun's variables and a free port (`tests/torch_dp_rank.py`; they
import no JAX), against hma_tpu's dp=2 mesh over two of conftest's eight
virtual CPU devices in this process.

- The 2-rank train step (each rank on its half of the global batch, the
  halves holding unequal masked counts) equals hma_tpu's dp=2 step on the
  global batch, for both families (the discrete one with sliced gradients,
  whose row grads are reduced too): params 1e-5, first moments 2e-5, second
  moments 4e-5 of max |want| per tensor, losses 1e-5 relative, as
  tests/test_torch_train_step.py; the ranks hold the same parameters, bit
  for bit.
- `train_multi` on 2 ranks for 3 steps from the same initial weights as
  hma_tpu's `--dp 2` run: the same losses on both ranks, equal to hma_tpu's
  at 1e-5 relative; only rank 0 writes; the run resumed from step 2 ends bit
  for bit where the straight one does.
- The 2-rank step drawing its own dropout masks, action drops and
  diffusion noise (nothing handed in; joint cards of both families with MLP
  dropout, the continuous one with diffusion_batch_mul 2, the discrete one
  over two microbatches) equals the port's 1-process step on the global
  batch: a rank draws its rows of the global batch's draws.
- `evaluate` on 2 ranks, sampling at temperature 1 with ΔPSNR's perturbed
  rollouts, equals 1 process on the same examples: the samples bit for bit,
  the token metrics at 1e-6 and the pixel metrics at 1e-5 relative;
  `evaluate_feature` on 2 ranks equals 1 process (latent MSEs and
  fid_latent at 1e-5 relative).
- In this process: `local_slice`, `round_batch` and `data_degree` equal
  hma_tpu's under a faked world of 2; a rank's collate rows are the whole
  batch's; a subset mesh, tp/sp above 1 and "auto" raise.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.parallel import distributed as jax_dist
from hma_tpu.parallel import mesh as jax_mesh
from hma_tpu.parallel import sharded_eval as jax_sharded_eval
from hma_tpu.train import step as jax_step
from hma_tpu.train import trainer as jax_trainer
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig, load_config
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.data.collators import maskgit_collate, maskgit_collate_feature
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel import mesh as port_mesh
from hma_tpu_torch.parallel import sharded_eval
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.train_multi import parse_args
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from torch_dp_rank import train_case
from torch_port_helpers import (
    JaxTrainingDraws,
    jax_tree_from_port,
    port_model,
    tiny_card,
    tiny_mar_card,
)

ROOT = Path(__file__).resolve().parent.parent
LR, WD, EPS = 3e-3, 0.05, 1e-3  # as tests/torch_dp_rank.py
REL = {"params": 1e-5, "m": 2e-5, "v": 4e-5}
DOMAINS = ("language_table", "bridge")
B = 4  # the step cases' global batch: rows 0-1 on rank 0, 2-3 on rank 1
ONE = {"params": 1e-6, "m": 1e-6, "v": 2e-6}  # 2 ranks against 1 process, both the port
JOINT_DROPOUT = dict(jointly_predict_actions=True, mlp_drop=0.1)
# (continuous, card, global microbatch) of the steps that draw their own
DRAWN = {"discrete_drawn": (False, JOINT_DROPOUT, 2),
         "continuous_drawn": (True, dict(diffusion_batch_mul=2, **JOINT_DROPOUT), 0)}
PIXEL = ("psnr", "ssim", "delta_psnr", "psnr_copy_prev", "psnr_vs_copy")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _domains(card: dict, n: int) -> dict:
    return {**card, "action_domains": [f"d{i}" for i in range(n)],
            "d_actions": [4] * n, "action_stats": card["action_stats"][:1] * n}


def _case_batch(continuous: bool, card: dict, seed: int, domain_id: int) -> dict:
    """A global batch whose halves hold unequal masked counts (about 30 %
    of rank 0's tokens, 70 % of rank 1's)."""
    rng = np.random.default_rng(seed)
    T = card["T"]
    rate = np.array([0.3, 0.3, 0.7, 0.7]).reshape(B, 1, 1)
    actions = rng.normal(size=(B, T, 4)).astype(np.float32)
    if continuous:
        h, C = 4, card["vae_embed_dim"]
        lat = rng.normal(size=(B, T, h, h, C)).astype(np.float32)
        mask = (rng.random((B, T, h * h)) < rate).reshape(B, T, h, h).astype(np.int32)
        mask[:, 0] = 0
        return {"input_ids": lat, "labels": lat, "masked_tokens_indicator": mask,
                "action_ids": actions, "domain_id": np.int32(domain_id)}
    V, S = card["image_vocab_size"], card["S"]
    labels = rng.integers(0, V, (B, T, S)).astype(np.int32)
    mask = rng.random((B, T, S)) < rate
    mask[:, 0] = False
    return {"input_ids": np.where(mask, V, labels).astype(np.int32), "labels": labels,
            "action_ids": actions, "domain_id": np.int32(domain_id)}


def _torch_batch(b: dict) -> dict:
    return {k: (torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 and k != "masked_tokens_indicator" else v)
                if np.ndim(v) else int(v)) for k, v in b.items()}


def _drawn_case(case: str) -> dict:
    """A spec of `train_case` whose steps draw their own (nothing handed
    in): two steps (domains 1, 2) of a 3-domain joint card at one layer."""
    continuous, kw, microbatch = DRAWN[case]
    base = (tiny_mar_card if continuous else tiny_card)(num_layers=1, **kw)
    card = _domains(base, 3)
    model = port_model(STMAR if continuous else STMaskGIT, card, seed=6)
    return {"continuous": continuous, "card": card, "card_more": _domains(base, 4),
            "state": model.state_dict(), "microbatch": microbatch,
            "batches": [_torch_batch(_case_batch(continuous, card, 20 + i, d))
                        for i, d in enumerate((1, 2))]}


def _jax_case(continuous: bool) -> tuple:
    """hma_tpu's train step on a dp=2 mesh, 2 steps (domains 1, 2) of the
    domain-sliced AdamW on a 3-domain tiny card at one layer: (what the
    ranks need, what they must end with)."""
    # one layer: the data-parallel sums do not depend on depth, and each
    # layer more adds seconds of tracing and compiling to the JAX side
    base = (tiny_mar_card if continuous else tiny_card)(num_layers=1)
    card, card_more = _domains(base, 3), _domains(base, 4)
    jcfg_cls, jm_cls = ((JaxDiffusionGenieConfig, JaxSTMAR) if continuous
                        else (JaxGenieConfig, JaxSTMaskGIT))
    jcfg = jcfg_cls(**card)
    jm = jm_cls(jcfg, dtype=jnp.float32)
    batches = [_case_batch(continuous, card, 10 + i, d) for i, d in enumerate((1, 2))]
    keys = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "action_drop": jax.random.PRNGKey(2)}
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    args = [b0["input_ids"], b0["labels"], b0["action_ids"], b0["domain_id"]]
    if continuous:
        args.append(b0["masked_tokens_indicator"])
    rng = np.random.default_rng(5)  # random draws of the init's shapes: nothing compiled
    params = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
                          jax.eval_shape(jm.init, keys, *args))
    other = jax.eval_shape(jm_cls(jcfg_cls(**card_more), dtype=jnp.float32).init, keys, *args)
    mask = jax_step.domain_stacked_mask(params, other)
    tx = jax_step.make_domain_sliced_optimizer(
        jax_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS, params_template=params,
        stacked_mask=mask, num_domains=3)
    step = jax_step.make_train_step(jm, tx, continuous=continuous,
                                    action_loss_weight=jcfg.action_loss_weight)

    @jax.jit
    def step_rec(state, batch, rng):
        with JaxTrainingDraws() as rec:
            state, metrics = step(state, batch, rng)
        return state, metrics, rec.tree()

    mesh = jax_mesh.make_mesh(2, dp=2)
    put, rep = jax_mesh.batch_sharding(mesh), NamedSharding(mesh, PartitionSpec())
    state = jax_step.TrainState(jax.device_put(params, rep),
                                jax.device_put(jax.jit(tx.init)(params), rep), jnp.asarray(0))
    losses, draws = [], []
    for i, b in enumerate(batches):
        dev = {k: (jax.device_put(v, put(v)) if np.ndim(v) else jnp.asarray(v))
               for k, v in b.items()}
        state, metrics, tree = step_rec(state, dev, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        if continuous:
            draws.append(JaxTrainingDraws.of(tree).draws(0, 0))
    cfg = (DiffusionGenieConfig if continuous else GenieConfig)(**card)
    opt = state.opt_state

    def port(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), cfg)

    spec = {"continuous": continuous, "card": card, "card_more": card_more,
            "state": port(params), "batches": [_torch_batch(b) for b in batches],
            "draws": draws}
    want = {"params": port(state.params),
            "m": port(jax_step._combine(mask, opt.dense[0].mu, opt.m)),
            "v": port(jax_step._combine(mask, opt.dense[0].nu, opt.v)),
            "domain_count": np.asarray(opt.count).tolist(), "count": int(opt.gcount),
            "losses": losses}
    return spec, want, cfg


def _write_data(root: Path) -> Path:
    data = root / "data"
    rng = np.random.default_rng(0)
    vocab = 2**18
    for domain in DOMAINS:
        for split, n in (("train", 80), ("val", 40)):
            write_token_dataset(
                data / f"{domain}_magvit_max1000000_{split}",
                rng.integers(0, vocab, (n, 4, 4)).astype(np.uint32),
                np.repeat(np.arange(n // 10), 10), rng.normal(size=(n, 2)).astype(np.float32),
                {"name": domain, "vocab_size": vocab, "s": 16})
    write_token_dataset(data / "latent_val", rng.normal(size=(30, 4, 4, 4)).astype(np.float16),
                        np.repeat(np.arange(3), 10), rng.normal(size=(30, 4)).astype(np.float32),
                        {"name": "d1", "latent_channels": 4})
    GenieConfig(num_layers=1, num_heads=2, d_model=32, T=4, S=16, image_vocab_size=vocab,
                num_factored_vocabs=2, action_token_size=8, action_network="concat+modulate",
                num_prompt_frames=2, use_actions=True).save_pretrained(str(root / "config.json"))
    (root / "split.yaml").write_text(yaml.safe_dump({"domains": ",".join(DOMAINS)}))
    return data


def _train_argv(root: Path, data: Path) -> list:
    return ["--genie_config", str(root / "config.json"), "--train_split",
            str(root / "split.yaml"), "--data_root", str(data), "--window_size", "4",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "1",
            "--learning_rate", "3e-3", "--adam_eps", str(EPS), "--max_train_steps", "3",
            "--eval_every_n_steps", "1000", "--max_eval_steps", "1",
            "--num_warmup_steps", "1", "--log_every", "1", "--seed", "3",
            "--checkpointing_steps", "2", "--device", "cpu"]


def _initial_weights(argv: list):
    """(state dict, config) of the trainer's model on this data: the weights
    both trainers start from."""
    args = parse_args([*argv, "--output_dir", "unused"])
    config = load_config(args.genie_config)
    domains, _, _, dims, stats, shared = trainer.build_domain_datasets(args, config)
    config = trainer.configure_model(args, config, domains, dims, stats, shared)
    model = STMaskGIT(config, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(7))
    return model.state_dict(), config


def _jax_train(root: Path, data: Path, init: dict, cfg, **factors) -> list:
    """hma_tpu's `--dp 2` run (or with the mesh `factors`) on the same data
    and flags, in fp32, from `init`: its loss at each step."""
    real = jax_trainer.TrainState

    def from_init(params, opt_state, step):
        tree = jax_tree_from_port(init, params, cfg)
        return real(jax.tree.map(lambda new, old: jax.device_put(new, old.sharding),
                                 tree, params), opt_state, step)

    def fp32_model(args, config, single_domain_params=False):
        """hma_tpu's model in fp32, its init jitted (one compile, not one an
        op)."""
        cls = jax_trainer.STMaskGIT if args.model_type == "discrete" else jax_trainer.STMAR
        model = cls(config, dtype=jnp.float32, remat=args.grad_checkpointing,
                    single_domain_params=single_domain_params)
        return type("Jitted", (), {"init": staticmethod(jax.jit(model.init)),
                                   "__getattr__": lambda self, n: getattr(model, n)})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "TrainState", from_init)
        mp.setattr(jax_trainer, "make_model", fp32_model)
        # only the training losses are compared: no eval pass, no checkpoint
        mp.setattr(jax_trainer, "run_eval", lambda *a, **kw: {})
        mp.setattr(jax_trainer, "save_checkpoint", lambda *a, **kw: None)
        jax_trainer.run_training(jax_trainer.TrainArgs(
            genie_config=str(root / "config.json"), output_dir=str(root / "jax"),
            train_split=str(root / "split.yaml"), data_root=str(data), window_size=4,
            per_device_train_batch_size=2, per_device_eval_batch_size=1,
            learning_rate=3e-3, adam_eps=EPS, max_train_steps=3, eval_every_n_steps=1000,
            max_eval_steps=1, num_warmup_steps=1, log_every=1, seed=3,
            **(factors or {"dp": 2})))
    lines = [json.loads(l) for l in open(root / "jax" / "metrics.jsonl")]
    return [l["train/loss"] for l in lines if "train/loss" in l]


def _save(obj, path: Path) -> None:
    """torch.save, then a rename: a rank polling for `path` never reads a
    file half written."""
    torch.save(obj, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Everything the module compares, made once. The two ranks start first
    (train_multi, evaluate, evaluate_feature need nothing of JAX) and take
    the step cases once this process has written them; hma_tpu's sides run
    here meanwhile."""
    root = tmp_path_factory.mktemp("dp")
    data = _write_data(root)
    argv = _train_argv(root, data)
    init, init_cfg = _initial_weights(argv)
    torch.save(init, root / "init.pt")
    cfg = DiffusionGenieConfig(**_domains(tiny_mar_card(num_layers=1), 3))
    save_checkpoint(str(root), "mar", STMAR(cfg, dtype=torch.float32, device="cpu",
                                            generator=torch.Generator().manual_seed(4))
                    .state_dict(), cfg)
    (root / "train_argv.json").write_text(json.dumps(argv))
    drawn = {case: _drawn_case(case) for case in DRAWN}
    for case, spec in drawn.items():
        _save(spec, root / f"{case}_case.pt")
    # the small codec (4x4 token grids <-> 8x8 frames), for the pixel metrics
    vq_cfg = VQConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    torch.save({"state_dict": VQModel(vq_cfg, dtype=torch.float32, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
                .state_dict()}, root / "tok.ckpt")
    vq_cfg.save_pretrained(str(root / "tok.ckpt.json"))
    # sampled at temperature 1, with ΔPSNR's perturbed-action rollouts
    eval_argv = ["--checkpoint_dir", str(root / "port_a" / "final_checkpt"),
                 "--val_data_dir", str(data / f"{DOMAINS[0]}_magvit_max1000000_val"),
                 "--batch_size", "4", "--max_examples", "8", "--temperature", "1.0",
                 "--tokenizer_ckpt", str(root / "tok.ckpt"), "--num_action_trials", "2",
                 "--perturbation_scale", "0.5", "--seed", "5", "--device", "cpu"]
    (root / "eval_argv.json").write_text(json.dumps(
        [*eval_argv, "--output_dir", str(root / "eval2"), "--save_outputs_dir",
         str(root / "samples2")]))
    feature_argv = ["--checkpoint_dir", str(root / "mar"), "--val_data_dir",
                    str(data / "latent_val"), "--batch_size", "2", "--max_examples", "4",
                    "--maskgit_steps", "1", "--compute_fid", "--seed", "2", "--device", "cpu"]
    (root / "feature_argv.json").write_text(json.dumps(
        [*feature_argv, "--output_dir", str(root / "feat2")]))

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HMA_TPU_", "XLA_", "JAX_"))}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"), str(root)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        one_process = {case: train_case(spec) for case, spec in drawn.items()}
        want = {}
        for case in ("discrete", "continuous"):
            spec, want[case], _ = _jax_case(case == "continuous")
            _save(spec, root / f"{case}_case.pt")
        jax_losses = _jax_train(root, data, init, init_cfg)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DP_OK" in out, f"rank {r}:\n{out[-6000:]}"
    one = evaluate_main([*eval_argv, "--output_dir", str(root / "eval1"),
                         "--save_outputs_dir", str(root / "samples1")])
    one_feature = evaluate_feature_main([*feature_argv, "--output_dir", str(root / "feat1")])
    return dict(root=root, want=want, jax_losses=jax_losses, one_process_eval=one,
                one_process_feature=one_feature, one_process_steps=one_process)


def _assert_close(got: dict, want: dict, what: str, rel: dict = REL):
    assert set(got) == set(want), what
    for n, w in want.items():
        err, scale = (got[n].float() - w).abs().max().item(), w.abs().max().item()
        assert err <= rel[what] * scale + 1e-8, \
            f"{what} {n}: max|d| {err:.3e}, max|want| {scale:.3e}"


@pytest.mark.parametrize("case", ["discrete", "continuous"])
def test_two_rank_steps_match_jax_dp2_mesh(dp_run, case):
    root, want = dp_run["root"], dp_run["want"][case]
    ranks = [torch.load(root / f"{case}_rank{r}.pt", weights_only=False) for r in range(2)]
    got = ranks[0]
    for what in ("params", "m", "v"):
        _assert_close(got[what], want[what], what)
        for n, t in got[what].items():  # the ranks' replicas agree bit for bit
            assert torch.equal(t, ranks[1][what][n]), (what, n)
    assert got["domain_count"] == want["domain_count"] == [0, 1, 1]
    assert got["count"] == want["count"] == 2
    for r in ranks:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        assert all(m["skipped"] == 0.0 for m in r["metrics"])


@pytest.mark.parametrize("case", list(DRAWN))
def test_two_ranks_drawing_their_rows_equal_one_process(dp_run, case):
    """Nothing handed in: each rank draws its rows of the global batch's
    dropout masks, action drops and diffusion noise, so 2 ranks take the
    step 1 process takes (as hma_tpu's dp mesh draws at the global shape)."""
    root, one = dp_run["root"], dp_run["one_process_steps"][case]
    ranks = [torch.load(root / f"{case}_rank{r}.pt", weights_only=False) for r in range(2)]
    for what in ("params", "m", "v"):
        _assert_close(ranks[0][what], one[what], what, ONE)
        for n, t in ranks[0][what].items():
            assert torch.equal(t, ranks[1][what][n]), (what, n)
    assert ranks[0]["domain_count"] == one["domain_count"] == [0, 1, 1]
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got["skipped"] == want["skipped"] == 0.0
            for k in ("loss", "action_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_two_rank_train_multi_matches_jax_and_resumes(dp_run):
    root = dp_run["root"]
    ranks = [json.loads((root / f"train_rank{r}.json").read_text()) for r in range(2)]
    losses = [[m["loss"] for m in r["straight"]] for r in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], dp_run["jax_losses"], rtol=1e-5)
    # the resumed run takes step 3 as the straight one did, and ends where it does
    assert [m["loss"] for m in ranks[0]["resumed"]] == losses[0][2:]
    for name in ("model.pt", "train_state.pt"):
        a, b = (torch.load(root / run / "final_checkpt" / name, weights_only=True)
                for run in ("port_a", "port_b"))
        flat_a, flat_b = (dict(_leaves(x)) for x in (a, b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            assert (torch.equal(v, flat_b[k]) if torch.is_tensor(v) else v == flat_b[k]), k
    # only rank 0 writes: its checkpoints, one metrics file with one config line
    assert ranks[0]["writers"] and set(ranks[0]["writers"]) == {0}
    assert ranks[1]["writers"] == []
    lines = [json.loads(l) for l in open(root / "port_a" / "metrics.jsonl")]
    assert sum("_config" in l for l in lines) == 1
    assert [l["_step"] for l in lines if "train/loss" in l] == [1, 2, 3]
    assert lines[0]["_config"]["world_size"] == 2
    assert lines[0]["_config"]["sliced_grads_active"] is False  # auto: off under a mesh


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix, x


def test_two_rank_evaluate_equals_one_process(dp_run):
    root, one = dp_run["root"], dp_run["one_process_eval"]
    ranks = [json.loads((root / f"eval_rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["jax_loaded"] == []
        got = r["evaluate"]
        assert got["num_examples"] == one["num_examples"] == 8
        for k in ("loss", "perplexity", "acc"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, err_msg=k)
        for k in PIXEL:  # metrics of the sampled rollouts
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)
    assert one["delta_psnr"] != 0.0
    # the samples themselves: rank r's rows of each batch are 1 process's
    for lo in (0, 4):
        whole = np.load(root / "samples1" / f"pred_{lo}_r0.npy")
        parts = [np.load(root / "samples2" / f"pred_{lo}_r{r}.npy") for r in range(2)]
        np.testing.assert_array_equal(np.concatenate(parts), whole)
    feats, one_feature = [r["evaluate_feature"] for r in ranks], dp_run["one_process_feature"]
    assert feats[0] == feats[1] and feats[0]["num_examples"] == one_feature["num_examples"] == 4
    for k in ("latent_mse", "latent_mse_per_frame", "fid_latent"):
        np.testing.assert_allclose(feats[0][k], one_feature[k], rtol=1e-5, err_msg=k)
    assert (root / "eval2" / "metrics.jsonl").is_file()


def test_slices_and_degrees_match_jax(monkeypatch):
    idx = np.arange(10, 22)
    for world in (1, 2, 3, 4):
        for r in range(world):
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            monkeypatch.setattr(dist, "process_count", lambda w=world: w)
            monkeypatch.setattr(dist, "process_index", lambda r=r: r)
            np.testing.assert_array_equal(dist.local_slice(idx), jax_dist.local_slice(idx))

            class Mesh:  # hma_tpu's pure-dp mesh over one device a process
                shape = {"dp": world, "fsdp": 1}

            assert sharded_eval.data_degree() == jax_sharded_eval.data_degree(Mesh)
            for n in (0, 1, 5, 8, 13):
                assert sharded_eval.round_batch(n) == \
                    jax_sharded_eval.round_batch(n, Mesh)
    assert port_mesh.default_mesh_factors(8) == jax_mesh.default_mesh_factors(8)
    assert port_mesh.default_mesh_factors(2) == jax_mesh.default_mesh_factors(2)


def test_collate_rows_are_the_whole_batch():
    """Each rank's rows, collated with the whole batch's draws, are the rows
    of the batch one process collates: the draws of hma_tpu's dp=2 mesh."""
    card = GenieConfig(**tiny_card())
    rng = np.random.default_rng(0)
    tok = [{"input_ids": rng.integers(0, 2**18, 64), "h": 4, "w": 4, "domain": "a"}
           for _ in range(6)]
    lat = [{"input_ids": rng.normal(size=(64, 4)).astype(np.float32), "h": 4, "w": 4,
            "domain": "a"} for _ in range(6)]
    for collate, items in ((maskgit_collate, tok), (maskgit_collate_feature, lat)):
        for seed in range(4):
            whole = collate(items, card, np.random.default_rng(seed))
            for rows in (np.arange(0, 3), np.arange(3, 6), np.array([1, 4])):
                part = collate([items[i] for i in rows], card, np.random.default_rng(seed),
                               rows, len(items))
                for k in ("input_ids", "labels", "masked_tokens_indicator"):
                    if k in whole:
                        np.testing.assert_array_equal(part[k], whole[k][rows], err_msg=k)


def test_what_cannot_run_raises(monkeypatch, tmp_path):
    # tp and sp run (tests/test_torch_tp.py, tests/test_torch_sp.py), beside
    # fsdp and each other too; dp is the rest of the world
    assert port_mesh.check_factors(tp=2, world=2) == 1
    assert port_mesh.check_factors(sp=2, world=2) == 1
    assert port_mesh.check_factors(fsdp=2, sp=2, world=4) == 1
    assert port_mesh.check_factors(tp=2, sp=2, world=8) == 2
    # factors the world cannot fill, more or fewer: no subset mesh
    for dp in (1, 4):
        with pytest.raises(ValueError, match="world has 2"):
            port_mesh.check_factors(dp, world=2)
    for kw in ({"fsdp": 2}, {"dp": 2, "fsdp": 2}, {"sp": 2}):  # one process: no group to split over
        with pytest.raises(ValueError, match="world has 1"):
            port_mesh.check_factors(**kw, world=1)
    with pytest.raises(ValueError, match="world has 1"):
        port_mesh.make_mesh(dp=2)
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh()
    # a dp the one process cannot fill, in the trainer, before any work
    with pytest.raises(ValueError, match="world has 1"):
        train_main(["--genie_config", str(tmp_path / "none.json"), "--output_dir",
                    str(tmp_path / "o"), "--dp", "2", "--device", "cpu"])
    # TPU metadata discovery, and a world of two with no address
    monkeypatch.setenv("HMA_TPU_COORDINATOR", "auto")
    with pytest.raises(NotImplementedError, match="metadata"):
        dist.init_distributed(device="cpu")
    monkeypatch.delenv("HMA_TPU_COORDINATOR")
    monkeypatch.setenv("HMA_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("HMA_TPU_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="coordinator"):
        dist.init_distributed(device="cpu")
    # the native loader is one process only, as in hma_tpu
    monkeypatch.delenv("HMA_TPU_NUM_PROCESSES")
    monkeypatch.setattr(trainer.distributed, "init_distributed", lambda device=None: False)
    monkeypatch.setattr(trainer.distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="native_loader"):
        train_main(["--genie_config", str(tmp_path / "none.json"), "--output_dir",
                    str(tmp_path / "o"), "--use_native_loader", "--device", "cpu"])
