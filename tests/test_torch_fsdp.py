"""fsdp (the mesh's "fsdp" axis, parameters and optimizer state sharded by
FSDP2), port vs hma_tpu on the CPU: two gloo ranks, launched once for the
module as subprocesses (`tests/torch_dp_rank.py ROOT 2`; they import no
JAX), against hma_tpu's `make_mesh(2, dp=1, fsdp=2)` over two of
conftest's eight virtual CPU devices in this process.

- The 2-rank fsdp train step (each rank on its half of the global batch,
  the halves holding unequal masked counts, the domain-sliced AdamW) equals
  hma_tpu's fsdp=2 step, for both families and both moment dtypes: params
  1e-5, fp32 first moments 2e-5 and second moments 4e-5 of max |want|,
  losses 1e-5 relative, as tests/test_torch_data_parallel.py holds dp; bf16
  moments take hma_tpu's stochastic-rounding bits (drawn at each leaf's
  global shape, a rank keeping its shard's part) and are held to the fp32
  moments' tolerances but for at most 1e-3 of their elements (as
  tests/test_torch_lowp_mup.py counts them), which may be a bf16 step
  apart for each of the 2 steps: where the two frameworks' fp32 moments
  differ in their last bits (XLA's CPU fma, reduction order), the random
  threshold can fall between them. The parameters are held to 1e-5 where
  both moments are within tolerance, and to the update's share of those
  steps (LR * 2^-6) where one is not.
- Each rank's shard of every parameter of at least 2^16 elements lies on
  the dimension hma_tpu's param_spec names, with the shape of hma_tpu's
  shard; the smaller ones on their last dimension.
- fsdp 2 drawing its own dropout, action drops and diffusion noise equals
  the port's one process on the global batch.
- `train_multi --fsdp 2` for 3 steps equals hma_tpu's `--fsdp 2` losses to
  1e-5 relative; only rank 0 writes; the run resumed from its step 2 ends
  bit for bit where the straight one does; its step-2 checkpoint resumes in
  one process, and one process's in fsdp 2, to the same third step.
- `evaluate` / `evaluate_feature --fsdp 2` equal one process.
- HSDP: four more ranks as (dp 2, fsdp 2) take the discrete step, against
  hma_tpu's `make_mesh(4, dp=2, fsdp=2)` step.
- In this process: the port's `shard_dim` equals hma_tpu's param_spec on
  every parameter of the full-size d256 discrete and 40-domain d512 STMAR
  cards at fsdp 2 and 8, and at fsdp 8 param_spec shards at least 85 % of
  the d512 card's fp32 parameters and both moments (the counterpart of
  tests/test_memory_budget.py).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from hma_tpu.config import DiffusionGenieConfig as JaxDiffusionGenieConfig
from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mar import STMAR as JaxSTMAR
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu.parallel import mesh as jax_mesh
from hma_tpu.train import step as jax_step
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig, load_config
from hma_tpu_torch.convert import params_from_jax
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel import mesh as port_mesh
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.tokenizer.magvit2 import VQConfig, VQModel
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_data_parallel import (
    B,
    EPS,
    LR,
    ONE,
    PIXEL,
    REL,
    WD,
    _assert_close,
    _case_batch,
    _domains,
    _drawn_case,
    _free_port,
    _initial_weights,
    _jax_train,
    _leaves,
    _save,
    _torch_batch,
    _train_argv,
    _write_data,
)
from test_torch_lowp_mup import MOMENT_SHARE, _port_noise, _recorded_bits
from torch_dp_rank import train_case
from torch_port_helpers import JaxTrainingDraws, port_names, tiny_card, tiny_mar_card

ROOT = Path(__file__).resolve().parent.parent
# (continuous, bf16 moments) of the cases held to hma_tpu's fsdp=2 step
JAX_CASES = {"discrete": (False, False), "continuous": (True, False),
             "discrete_bf16": (False, True), "continuous_bf16": (True, True)}
# the cases that draw their own (nothing handed in): (dp test case, moments)
OWN_DRAWS = {"discrete_drawn": ("discrete_drawn", None),
             "continuous_drawn": ("continuous_drawn", None),
             "continuous_drawn_bf16": ("continuous_drawn", "bfloat16")}
CASES = [*OWN_DRAWS, *JAX_CASES]


def _jax_card(continuous: bool) -> dict:
    """One layer, 3 domains, widths at which some parameters reach 2^16
    elements (the discrete readout at d 64, the head's adaLN and fc at width
    256), so that param_spec shards them."""
    if continuous:
        return _domains(tiny_mar_card(num_layers=1, diffloss_w=256), 3)
    return _domains(tiny_card(num_layers=1, d_model=64), 3)


def _jax_case(continuous: bool, bf16: bool, dp: int = 1, fsdp: int = 2, tp: int = 1,
              card: dict = None, sp: int = 1, steps: int = 2) -> tuple:
    """hma_tpu's train step on a (dp, fsdp, tp, sp) mesh (parameters placed by
    make_param_shardings, the optimizer initialised under jit so its moments
    inherit them, as hma_tpu's trainer does), `steps` steps (domains 1, 2) of the
    domain-sliced AdamW on `card` (default `_jax_card`'s, with 3 domains):
    (what the ranks need, what they must end with, the placements hma_tpu
    gives: {port name: (fsdp dim, shard shape, size, tp dim)}, the dims and
    shapes the port's)."""
    card = _domains(card, 3) if card else _jax_card(continuous)
    card_more = _domains(card, 4)
    jcfg_cls, jm_cls = ((JaxDiffusionGenieConfig, JaxSTMAR) if continuous
                        else (JaxGenieConfig, JaxSTMaskGIT))
    jcfg = jcfg_cls(**card)
    jm = jm_cls(jcfg, dtype=jnp.float32)
    # bf16: one step, as a bf16 step apart in one step's moments moves the
    # next step's parameters and so all its gradients
    batches = [_case_batch(continuous, card, 10 + i, d)
               for i, d in enumerate((1, 2)[:1 if bf16 else steps])]
    keys = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
            "action_drop": jax.random.PRNGKey(2)}
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    args = [b0["input_ids"], b0["labels"], b0["action_ids"], b0["domain_id"]]
    if continuous:
        args.append(b0["masked_tokens_indicator"])
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(jm.init, keys, *args)
    params = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes)
    other = jax.eval_shape(jm_cls(jcfg_cls(**card_more), dtype=jnp.float32).init, keys, *args)
    mask = jax_step.domain_stacked_mask(params, other)
    tx = jax_step.make_domain_sliced_optimizer(
        jax_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS, params_template=params,
        stacked_mask=mask, num_domains=3, moment_dtype=jnp.bfloat16 if bf16 else None)
    step = jax_step.make_train_step(jm, tx, continuous=continuous,
                                    action_loss_weight=jcfg.action_loss_weight)
    mesh = jax_mesh.make_mesh(dp * fsdp * tp * sp, dp=dp, fsdp=fsdp, tp=tp, sp=sp)
    shardings = jax_mesh.make_param_shardings(params, mesh)
    put, rep = jax_mesh.batch_sharding(mesh), NamedSharding(mesh, PartitionSpec())
    cfg = (DiffusionGenieConfig if continuous else GenieConfig)(**card)
    names = port_names(shapes, cfg)
    stacked_names = [n for n, s in zip(names, jax.tree.leaves(mask)) if s]
    dense_def = jax.tree.structure(jax_step._prune(mask, params, False))
    stacked_def = jax.tree.structure(jax_step._prune(mask, params, True))
    n_dense = dense_def.num_leaves
    with pytest.MonkeyPatch.context() as mp:
        sink = _recorded_bits(mp)

        @jax.jit
        def step_rec(state, batch, rng):
            sink.clear()
            with JaxTrainingDraws() as rec:
                state, metrics = step(state, batch, rng)
            return state, metrics, rec.tree(), list(sink)

        p = jax.device_put(params, shardings)
        opt = jax.tree.map(lambda x: x if len(x.sharding.device_set) == dp * fsdp * tp * sp
                           else jax.device_put(x, rep), jax.jit(tx.init)(p))
        state = jax_step.TrainState(p, opt, jax.device_put(jnp.asarray(0), rep))
        losses, draws, noise = [], [], []
        for i, b in enumerate(batches):
            dev = {k: (jax.device_put(v, put(v)) if np.ndim(v) else jnp.asarray(v))
                   for k, v in b.items()}
            state, metrics, tree, bits = step_rec(state, dev, jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            if continuous:
                draws.append(JaxTrainingDraws.of(tree).draws(0, 0))
            if bf16:  # the dense leaves' m bits, their v bits, then each row's m and v
                dense = [jax.tree.unflatten(dense_def, bits[k * n_dense:(k + 1) * n_dense])
                         for k in (0, 1)]
                rows = [jax.tree.unflatten(stacked_def, bits[2 * n_dense + k::2])
                        for k in (0, 1)]
                noise.append(_port_noise(*(jax_step._combine(mask, dense[k], rows[k])
                                           for k in (0, 1)), mask, stacked_names))
    opt = state.opt_state

    def port(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), cfg)

    spec = {"continuous": continuous, "card": card, "card_more": card_more,
            "state": port(params), "batches": [_torch_batch(b) for b in batches],
            "draws": draws, "noise": noise, "sliced": False,
            "moment_dtype": "bfloat16" if bf16 else None}
    want = {"params": port(state.params),
            "m": port(jax_step._combine(mask, opt.dense[0].mu, opt.m)),
            "v": port(jax_step._combine(mask, opt.dense[0].nu, opt.v)),
            "domain_count": np.asarray(opt.count).tolist(), "count": int(opt.gcount),
            "losses": losses}
    placements = {}
    for name, (path, s), sh in zip(names, jax.tree_util.tree_flatten_with_path(shapes)[0],
                                   jax.tree.leaves(shardings,
                                                   is_leaf=lambda x: hasattr(x, "spec"))):
        dense = getattr(path[-1], "key", None) == "kernel" and len(s.shape) == 2
        spec_ = tuple(sh.spec) + (None,) * (len(s.shape) - len(sh.spec))
        dim = spec_.index("fsdp") if "fsdp" in spec_ else None
        dim_tp = spec_.index("tp") if "tp" in spec_ else None
        shard = sh.shard_shape(s.shape)
        if dense:
            dim, shard = (None if dim is None else 1 - dim), shard[::-1]
            dim_tp = None if dim_tp is None else 1 - dim_tp
        placements[name] = (dim, tuple(shard), math.prod(s.shape), dim_tp)
    return spec, want, placements


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """Everything the module compares, made once. One process's 2-step run
    comes first (its step-2 checkpoint is what the ranks' third run
    resumes from); the two ranks then start and take the step cases once
    this process has written them; hma_tpu's sides run here meanwhile."""
    root = tmp_path_factory.mktemp("fsdp")
    data = _write_data(root)
    argv = _train_argv(root, data)
    init, init_cfg = _initial_weights(argv)
    torch.save(init, root / "init.pt")
    # one process on the ranks' global batch (2 a card x 2 ranks)
    one_argv = [a if a != "2" or argv[i - 1] != "--per_device_train_batch_size" else "4"
                for i, a in enumerate(argv)]

    class Loaded(STMaskGIT):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if kw.get("device") != "meta":
                self.load_state_dict(init)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "STMaskGIT", Loaded)
        train_main([*one_argv, "--output_dir", str(root / "port_one")])
    cfg = DiffusionGenieConfig(**_domains(tiny_mar_card(num_layers=1), 3))
    save_checkpoint(str(root), "mar", STMAR(cfg, dtype=torch.float32, device="cpu",
                                            generator=torch.Generator().manual_seed(4))
                    .state_dict(), cfg)
    fsdp = ["--fsdp", "2"]
    (root / "train_argv.json").write_text(json.dumps([*argv, *fsdp]))
    (root / "cases.json").write_text(json.dumps(CASES))
    drawn = {case: {**_drawn_case(base), "sliced": False, "moment_dtype": moments}
             for case, (base, moments) in OWN_DRAWS.items()}
    for case, spec in drawn.items():
        _save(spec, root / f"{case}_case.pt")
    vq_cfg = VQConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1)
    torch.save({"state_dict": VQModel(vq_cfg, dtype=torch.float32, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
                .state_dict()}, root / "tok.ckpt")
    vq_cfg.save_pretrained(str(root / "tok.ckpt.json"))
    eval_argv = ["--checkpoint_dir", str(root / "port_one" / "final_checkpt"),
                 "--val_data_dir", str(data / "language_table_magvit_max1000000_val"),
                 "--batch_size", "4", "--max_examples", "8", "--temperature", "1.0",
                 "--tokenizer_ckpt", str(root / "tok.ckpt"), "--num_action_trials", "2",
                 "--perturbation_scale", "0.5", "--seed", "5", "--device", "cpu"]
    (root / "eval_argv.json").write_text(json.dumps(
        [*eval_argv, *fsdp, "--output_dir", str(root / "eval2"), "--save_outputs_dir",
         str(root / "samples2")]))
    feature_argv = ["--checkpoint_dir", str(root / "mar"), "--val_data_dir",
                    str(data / "latent_val"), "--batch_size", "2", "--max_examples", "4",
                    "--maskgit_steps", "1", "--compute_fid", "--seed", "2", "--device", "cpu"]
    (root / "feature_argv.json").write_text(json.dumps(
        [*feature_argv, *fsdp, "--output_dir", str(root / "feat2")]))

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HMA_TPU_", "XLA_", "JAX_"))}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    hsdp = root / "hsdp"  # (dp 2, fsdp 2): the discrete step alone, 4 ranks
    hsdp.mkdir()
    (hsdp / "cases.json").write_text(json.dumps(["discrete"]))
    hsdp_env = {**env, "WORLD_SIZE": "4", "MASTER_PORT": str(_free_port())}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"), str(root), "2"],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    procs += [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"), str(hsdp), "2",
         "--steps_only"],
        env={**hsdp_env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        one_process = {case: train_case(spec) for case, spec in drawn.items()}
        want, placements = {}, {}
        spec, want["hsdp"], _ = _jax_case(False, False, dp=2)
        _save(spec, hsdp / "discrete_case.pt")
        for case, (continuous, bf16) in JAX_CASES.items():
            spec, want[case], placements[case] = _jax_case(continuous, bf16)
            _save(spec, root / f"{case}_case.pt")
        jax_losses = _jax_train(root, data, init, init_cfg, dp=1, fsdp=2)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DP_OK" in out, f"process {r}:\n{out[-6000:]}"
    # the fsdp run's step-2 checkpoint in one process
    train_main([*one_argv, "--output_dir", str(root / "one_from_fsdp"),
                "--resume_from_checkpoint", str(root / "port_a" / "step_2")])
    one = evaluate_main([*eval_argv, "--output_dir", str(root / "eval1"),
                         "--save_outputs_dir", str(root / "samples1")])
    one_feature = evaluate_feature_main([*feature_argv, "--output_dir", str(root / "feat1")])
    return dict(root=root, want=want, placements=placements, jax_losses=jax_losses,
                one_process_eval=one, one_process_feature=one_feature,
                one_process_steps=one_process)


def _bf16_within(got: dict, want: dict, what: str, rel: dict, steps: int) -> dict:
    """{name: elements of bf16 moment `got` within the fp32 tolerance of
    `want`}; the others must be at most a bf16 step a training step from
    `want`'s and at most MOMENT_SHARE of all."""
    within, differ, total = {}, 0, 0
    for n, w in want.items():
        g = got[n]
        assert g.dtype == torch.bfloat16, n
        err = (g.float() - w).abs()
        within[n] = err <= rel[what] * w.abs().max() + 1e-12
        assert (within[n] | (err <= w.abs() * 2**-7 * steps)).all(), f"{what} {n}"
        differ += int((~within[n]).sum())
        total += w.numel()
    assert differ <= MOMENT_SHARE * total, f"{what}: {differ} of {total}"
    return within


def _assert_state(ranks: list, want: dict, rel: dict, steps: int) -> None:
    """The ranks' parameters and moments (gathered whole) against `want`'s
    at `rel` of max |want|; bf16 moments as `_bf16_within`, and the
    parameters where one is not within at the update's share of a bf16 step
    a step (LR * 2^-7 * steps). The ranks gather the same tensors."""
    got = ranks[0]
    for what in ("params", "m", "v"):
        for n, t in got[what].items():
            assert all(torch.equal(t, r[what][n]) for r in ranks[1:]), (what, n)
    if next(iter(got["m"].values())).dtype != torch.bfloat16:
        for what in ("params", "m", "v"):
            _assert_close(got[what], want[what], what, rel)
        return
    m_ok, v_ok = (_bf16_within(got[k], want[k], k, rel, steps) for k in ("m", "v"))
    for n, w in want["params"].items():
        within = m_ok[n] & v_ok[n]
        err = (got["params"][n] - w).abs()
        assert (err[within] <= rel["params"] * w.abs().max() + 1e-8).all(), n
        assert (err[~within] <= LR * 2**-7 * steps).all(), n


def _ranks(root: Path, case: str, world: int = 2) -> list:
    return [torch.load(root / f"{case}_rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_fsdp_steps_match_jax_fsdp2_mesh(fsdp_run, case):
    want = fsdp_run["want"][case]
    ranks = _ranks(fsdp_run["root"], case)
    steps = len(want["losses"])
    _assert_state(ranks, want, REL, steps)
    got = ranks[0]
    assert got["domain_count"] == want["domain_count"] == [0, 1, int(steps == 2)]
    assert got["count"] == want["count"] == steps
    for r in ranks:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        assert all(m["skipped"] == 0.0 for m in r["metrics"])


def test_hsdp_step_matches_jax_dp2_fsdp2_mesh(fsdp_run):
    """HSDP: 4 ranks as (dp 2, fsdp 2), each on its row of the global batch,
    parameters replicated over "dp" and sharded over "fsdp", against
    hma_tpu's make_mesh(4, dp=2, fsdp=2) step."""
    want = fsdp_run["want"]["hsdp"]
    ranks = _ranks(fsdp_run["root"] / "hsdp", "discrete", 4)
    _assert_state(ranks, want, REL, 2)
    for r in ranks:
        assert r["domain_count"] == want["domain_count"] == [0, 1, 1]
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
    # each dp replica holds the fsdp=2 run's shards: rank 2 * i + j has rank j's
    fsdp2 = _ranks(fsdp_run["root"], "discrete")
    for r, got in enumerate(ranks):
        assert got["placements"] == fsdp2[r % 2]["placements"], r


@pytest.mark.parametrize("case", ["discrete", "continuous"])
def test_fsdp_placements_follow_param_spec(fsdp_run, case):
    """Each rank's shard: hma_tpu's dimension and shard shape for the
    parameters param_spec shards, the last dimension for the rest."""
    want = fsdp_run["placements"][case]
    ranks = _ranks(fsdp_run["root"], case)
    big = [n for n, (_, _, size, _) in want.items() if size >= port_mesh.FSDP_MIN_SIZE]
    assert big and any(want[n][0] is not None for n in big)  # something is sharded
    for r in ranks:
        got = r["placements"]
        assert set(got) == set(want)
        for n, (dim, shard, size, _) in want.items():
            if dim is not None:
                assert got[n] == (dim, shard), (n, got[n], dim, shard)
            else:
                shape = r["params"][n].shape
                assert got[n][0] == len(shape) - 1, n


@pytest.mark.parametrize("case", list(OWN_DRAWS))
def test_fsdp_ranks_drawing_their_rows_equal_one_process(fsdp_run, case):
    """Nothing handed in: the dropout masks, action drops, diffusion noise
    and (bf16) the moments' random bits are each rank's part of the global
    draws, so fsdp 2 takes the step one process takes."""
    root, one = fsdp_run["root"], fsdp_run["one_process_steps"][case]
    ranks = _ranks(root, case)
    _assert_state(ranks, one, ONE, 2)
    assert ranks[0]["domain_count"] == one["domain_count"] == [0, 1, 1]
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got["skipped"] == want["skipped"] == 0.0
            for k in ("loss", "action_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_fsdp_train_multi_matches_jax_and_checkpoints_cross(fsdp_run):
    root = fsdp_run["root"]
    ranks = [json.loads((root / f"train_rank{r}.json").read_text()) for r in range(2)]
    losses = [[m["loss"] for m in r["straight"]] for r in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], fsdp_run["jax_losses"], rtol=1e-5)
    assert [m["loss"] for m in ranks[0]["resumed"]] == losses[0][2:]
    for name in ("model.pt", "train_state.pt"):
        a, b = (torch.load(root / run / "final_checkpt" / name, weights_only=True)
                for run in ("port_a", "port_b"))
        flat_a, flat_b = (dict(_leaves(x)) for x in (a, b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            assert (torch.equal(v, flat_b[k]) if torch.is_tensor(v) else v == flat_b[k]), k
    assert ranks[0]["writers"] and set(ranks[0]["writers"]) == {0}
    assert ranks[1]["writers"] == []
    lines = [json.loads(l) for l in open(root / "port_a" / "metrics.jsonl")]
    assert sum("_config" in l for l in lines) == 1
    config = lines[0]["_config"]
    assert (config["world_size"], config["fsdp"], config["sliced_grads_active"]) == (2, 2, False)
    # across shardings, as 2 ranks are held to hma_tpu: one process on the
    # global batch trains as fsdp 2 does, fsdp's step-2 checkpoint resumes
    # in one process and one process's in fsdp 2, to the same third step
    def train_losses(run):
        return [json.loads(l)["train/loss"] for l in open(root / run / "metrics.jsonl")
                if "train/loss" in l]

    one = train_losses("port_one")
    np.testing.assert_allclose(one, losses[0], rtol=1e-5)
    np.testing.assert_allclose(train_losses("one_from_fsdp"), losses[0][2:], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in ranks[0]["from_one"]], one[2:], rtol=1e-5)
    whole = torch.load(root / "port_a" / "final_checkpt" / "model.pt", weights_only=True)
    assert {k: v.shape for k, v in whole.items()} == \
        {k: v.shape for k, v in torch.load(root / "port_one" / "final_checkpt" / "model.pt",
                                           weights_only=True).items()}


def test_fsdp_evaluate_equals_one_process(fsdp_run):
    root, one = fsdp_run["root"], fsdp_run["one_process_eval"]
    ranks = [json.loads((root / f"eval_rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["jax_loaded"] == []
        assert "item 10e" in r["sliced_refused"]
        got = r["evaluate"]
        assert got["num_examples"] == one["num_examples"] == 8
        for k in ("loss", "perplexity", "acc"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, err_msg=k)
        for k in PIXEL:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)
    for lo in (0, 4):
        whole = np.load(root / "samples1" / f"pred_{lo}_r0.npy")
        parts = [np.load(root / "samples2" / f"pred_{lo}_r{r}.npy") for r in range(2)]
        np.testing.assert_array_equal(np.concatenate(parts), whole)
    feats, one_feature = [r["evaluate_feature"] for r in ranks], fsdp_run["one_process_feature"]
    assert feats[0] == feats[1] and feats[0]["num_examples"] == one_feature["num_examples"] == 4
    for k in ("latent_mse", "latent_mse_per_frame", "fid_latent"):
        np.testing.assert_allclose(feats[0][k], one_feature[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# in this process: the sharding rule on the full-size cards

def _card_with_domains(path: str, n: int) -> dict:
    card = json.load(open(ROOT / "hma_tpu_torch" / "configs" / path))
    card.pop("Diffusion", None)
    rng = np.random.default_rng(0)
    dims = [int(rng.integers(2, 8)) for _ in range(n)]
    return {**card, "action_domains": [f"domain_{i}" for i in range(n)], "d_actions": dims,
            "action_stats": [[rng.normal(size=d).tolist(),
                              (np.abs(rng.normal(size=d)) + 0.5).tolist()] for d in dims]}


@pytest.fixture(scope="module")
def full_cards():
    """{name: (JAX eval_shape tree, port config, port model on the meta
    device)} of the d256 discrete card (2 domains) and the 40-domain d512
    STMAR card at 2 of their 32 layers (every layer's parameters have the
    same shapes; tracing all 32 takes seconds a card)."""
    out = {}
    for name, path, n, continuous in (("d256", "magvit_n32_h8_d256_action.json", 2, False),
                                      ("d512", "mar_n32_h8_d512_action.json", 40, True)):
        card = {**_card_with_domains(path, n), "num_layers": 2}
        jcls, jcfg_cls = ((JaxSTMAR, JaxDiffusionGenieConfig) if continuous
                          else (JaxSTMaskGIT, JaxGenieConfig))
        jcfg = jcfg_cls(**card)
        T, S = jcfg.T, jcfg.S
        act = jax.ShapeDtypeStruct((1, T, jcfg.max_d_action), jnp.float32)
        dom = jax.ShapeDtypeStruct((), jnp.int32)
        if continuous:
            lat = jax.ShapeDtypeStruct((1, T, jcfg.h, jcfg.h, jcfg.vae_embed_dim), jnp.float32)
            args = (lat, lat, act, dom, jax.ShapeDtypeStruct((1, T, jcfg.h, jcfg.h), jnp.int32))
        else:
            tok = jax.ShapeDtypeStruct((1, T, S), jnp.int32)
            args = (tok, tok, act, dom)
        shapes = jax.eval_shape(
            jcls(jcfg).init, {"params": jax.random.PRNGKey(0),
                              "diffusion": jax.random.PRNGKey(1),
                              "action_drop": jax.random.PRNGKey(2)}, *args)
        cfg = (DiffusionGenieConfig if continuous else GenieConfig)(**card)
        model = (STMAR if continuous else STMaskGIT)(cfg, device="meta")
        out[name] = (shapes, cfg, model)
    return out


@pytest.mark.parametrize("card", ["d256", "d512"])
def test_shard_dim_follows_param_spec_on_full_cards(full_cards, card):
    shapes, cfg, model = full_cards[card]
    owner = {f"{m}.{leaf}" if m else leaf: mod for m, mod in model.named_modules()
             for leaf, _ in mod.named_parameters(recurse=False)}
    params = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == len(params)
    for fsdp in (2, 8):
        mesh = type("Mesh", (), {"shape": {"dp": 1, "fsdp": fsdp, "tp": 1, "sp": 1}})
        for name, (path, s) in zip(port_names(shapes, cfg), flat):
            keys = tuple(getattr(k, "key", str(k)) for k in path)
            spec = tuple(jax_mesh.param_spec(keys, s, mesh))
            spec += (None,) * (len(s.shape) - len(spec))
            dim = spec.index("fsdp") if "fsdp" in spec else None
            p = params[name]
            if dim is not None and keys[-1] == "kernel" and len(s.shape) == 2:
                dim = 1 - dim
            got = port_mesh.shard_dim(owner[name], name.rpartition(".")[2], p, fsdp)
            assert got == (p.ndim - 1 if dim is None else dim), (fsdp, name, got, dim)


def test_flagship_state_shards_under_fsdp8():
    """The counterpart of tests/test_memory_budget.py: on the 40-domain d512
    STMAR card (1.5B parameters), param_spec at fsdp 8 leaves at most 20 %
    of the fp32 parameters and both moments on one rank (shards at least
    85 % of them, as hma_tpu's test requires)."""
    card = _card_with_domains("mar_n32_h8_d512_action.json", 40)
    model = STMAR(DiffusionGenieConfig(**card), device="meta")
    owner = {f"{m}.{leaf}" if m else leaf: mod for m, mod in model.named_modules()
             for leaf, _ in mod.named_parameters(recurse=False)}
    total = per_rank = sharded = 0
    for name, p in model.named_parameters():
        transposed = isinstance(owner[name], torch.nn.Linear) and p.ndim == 2
        dim = port_mesh.param_spec(p.shape, 8, transposed)
        nbytes = p.numel() * 4 * 3  # fp32 parameter, m and v
        total += nbytes
        per_rank += nbytes if dim is None else nbytes // 8
        sharded += 0 if dim is None else nbytes
    n_params = total // 12
    assert n_params > 1.2e9, n_params
    assert sharded >= 0.85 * total, sharded / total
    assert per_rank * 8 >= total and per_rank < 0.2 * total, per_rank / total
