"""tp (the mesh's "tp" axis: attention heads and MLP features split over
tensor-parallel ranks), port vs hma_tpu on the CPU: two gloo ranks,
launched once for the module as subprocesses (`tests/torch_dp_rank.py ROOT
1 2`; they import no JAX), against hma_tpu's `make_mesh(2, dp=1, fsdp=1,
tp=2)` over two of conftest's eight virtual CPU devices in this process.

- The tp 2 train step (both ranks on the whole global batch, the domain-
  sliced AdamW with full grads) equals hma_tpu's tp=2 step for both
  families with fp32 moments (params 1e-5, first moments 2e-5, second
  moments 4e-5 of max |want|, losses 1e-5 relative, as
  tests/test_torch_fsdp.py holds fsdp), and for one bf16-moment step with
  hma_tpu's stochastic-rounding bits recorded (drawn at each leaf's whole
  shape; a rank keeps its dealt columns), under test_torch_fsdp's per-
  element bf16 rule. The discrete card's MLP is 257 wide, which tp 2 does
  not divide: param_spec leaves it replicated and so does the port.
- The placements: each rank's local shape of every parameter is its shard
  under param_spec at tp 2, on the same dimension; the parts gathered and
  un-dealt equal the whole tensors bit for bit, and each part is the dealt
  columns of the whole (q, k, v of the rank's heads).
- tp 2 drawing its own dropout (MLP dropout 0.1, the hidden mask drawn at
  the whole width and sliced), action drops, diffusion noise and bf16 bits
  equals the port's one process, the cross-attention card in the
  reference's compat mode (every head gathered for its head-axis softmax)
  among them.
- The cached discrete rollout at temperature 0 gives one process's greedy
  tokens; the cached MAR rollout with handed-in draws one process's
  latents; each rank's caches hold H / tp heads.
- `train_multi --tp 2` for 3 steps equals hma_tpu's `--tp 2` losses to
  1e-5 relative; its step-2 checkpoint (whole, one process's layout)
  resumes in one process, and one process's in tp 2.
- `evaluate --tp 2` and `evaluate_feature --tp 2` equal one process.
- (fsdp 2, tp 2): four more ranks take the discrete step against
  hma_tpu's `make_mesh(4, dp=1, fsdp=2, tp=2)` step.
- In this process: the groups that (dp 2, tp 2) makes, rank by rank (a
  fake process group), and the dealt columns of qkv and ada_fc2.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.models.st_mask_git import STMaskGIT as JaxSTMaskGIT
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel import mesh as port_mesh
from hma_tpu_torch.parallel import tensor_parallel as tpar
from hma_tpu_torch.rollout.mar import generate_latents
from hma_tpu_torch.rollout.maskgit import generate_tokens
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_data_parallel import (
    ONE,
    REL,
    _case_batch,
    _domains,
    _drawn_case,
    _free_port,
    _initial_weights,
    _jax_train,
    _save,
    _torch_batch,
    _train_argv,
    _write_data,
)
from test_torch_fsdp import _assert_state, _jax_case, _ranks
from torch_dp_rank import train_case
from torch_port_helpers import (
    jax_mar_draws,
    jax_tree_from_port,
    port_model,
    tiny_card,
    tiny_mar_card,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# d 64 in 4 heads of 16; an MLP of 257 features, which tp 2 leaves whole
ODD_MLP = tiny_card(num_layers=1, d_model=64, num_heads=4, qk_norm=True, mlp_ratio=257 / 64)
CARDS = {"discrete": (False, False, ODD_MLP),
         "discrete_bf16": (False, True, ODD_MLP),
         "continuous": (True, False, tiny_mar_card(num_layers=1, num_heads=4, qk_norm=True,
                                                   diffloss_w=256))}
# (fsdp 2, tp 2): the MLP split too, pre-norms replicated beside the split layers
FSDP_TP = tiny_card(num_layers=1, d_model=64, num_heads=4)
# the cases that draw their own: (dp test case or a card, moments); the
# cross-attention card in the reference's compat mode, whose head-axis
# softmax gathers every head
OWN_DRAWS = {"discrete_drawn": ("discrete_drawn", None),
             "continuous_drawn_bf16": ("continuous_drawn", "bfloat16"),
             "cross_reference_drawn": (tiny_card(
                 num_layers=1, action_network="concat+cross_attention",
                 cross_attention_compat="reference", qk_norm=True,
                 jointly_predict_actions=True, mlp_drop=0.1), None)}


def _own_case(base, moments) -> dict:
    """A spec of `train_case` that draws its own (the dp test's, or two
    steps of `base` with 3 domains, as that test builds its)."""
    if isinstance(base, str):
        spec = _drawn_case(base)
    else:
        card = _domains(base, 3)
        spec = {"continuous": False, "card": card, "card_more": _domains(base, 4),
                "state": port_model(STMaskGIT, card, seed=6).state_dict(), "microbatch": 0,
                "batches": [_torch_batch(_case_batch(False, card, 20 + i, d))
                            for i, d in enumerate((1, 2))]}
    return {**spec, "sliced": False, "moment_dtype": moments}


def _rollout_cases() -> dict:
    """The two cached rollouts the ranks run: 2 layers, 4 heads (2 a rank),
    2 prompt frames of B 2, greedy tokens / handed-in MAR draws."""
    rng = np.random.default_rng(11)
    disc = tiny_card(num_heads=4)
    mar = tiny_mar_card(num_heads=4)
    mcfg = DiffusionGenieConfig(**mar)
    actions = torch.from_numpy(rng.normal(size=(2, 4, 4)).astype(np.float32))
    return {
        "discrete": {"card": disc, "state": port_model(STMaskGIT, disc, seed=12).state_dict(),
                     "tokens": torch.from_numpy(rng.integers(0, 2**18, (2, 4, 16))),
                     "actions": actions},
        "mar": {"card": mar, "state": port_model(STMAR, mar, seed=13).state_dict(),
                "latents": torch.from_numpy(rng.normal(size=(2, 4, 4, 4, 4)).astype(np.float32)),
                "actions": actions,
                "draws": jax_mar_draws(jax.random.PRNGKey(5), 2, 2, 4, mcfg.maskgit_steps,
                                       int(mcfg.num_sampling_steps), 16)}}


def _one_process_rollouts(cases: dict) -> dict:
    out = {}
    for name, case in cases.items():
        cls, cfg_cls = (STMAR, DiffusionGenieConfig) if name == "mar" else (STMaskGIT,
                                                                            GenieConfig)
        model = cls(cfg_cls(**case["card"]), dtype=torch.float32, device="cpu")
        model.load_state_dict(case["state"])
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            if name == "mar":
                out[name] = generate_latents(model.eval(), case["latents"], 2,
                                             case["actions"], 0, g, draws=case["draws"])
            else:
                out[name] = generate_tokens(model.eval(), case["tokens"], 2, case["actions"],
                                            0, g, maskgit_steps=2, temperature=0.0)
    return out


def _start(root, world: int, fsdp: int, extra=()) -> list:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HMA_TPU_", "XLA_", "JAX_"))}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_rank.py"), str(root),
         str(fsdp), "2", *extra],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Everything the module compares, made once: one process's 2-step run
    first (its step-2 checkpoint is what the ranks' third run resumes
    from), then the two tp ranks and the four (fsdp 2, tp 2) ranks, which
    take the step cases once this process has written them; hma_tpu's sides
    and one process's run here meanwhile."""
    root = tmp_path_factory.mktemp("tp")
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
    tp = ["--tp", "2"]
    (root / "train_argv.json").write_text(json.dumps([*argv, *tp]))
    (root / "cases.json").write_text(json.dumps([*OWN_DRAWS, *CARDS]))
    drawn = {case: _own_case(*spec) for case, spec in OWN_DRAWS.items()}
    for case, spec in drawn.items():
        _save(spec, root / f"{case}_case.pt")
    rollouts = _rollout_cases()
    _save(rollouts, root / "rollouts.pt")
    eval_argv = ["--checkpoint_dir", str(root / "port_one" / "final_checkpt"),
                 "--val_data_dir", str(data / "language_table_magvit_max1000000_val"),
                 "--batch_size", "4", "--max_examples", "8", "--seed", "5", "--device", "cpu"]
    (root / "eval_argv.json").write_text(json.dumps(
        [*eval_argv, *tp, "--output_dir", str(root / "eval2"), "--save_outputs_dir",
         str(root / "samples2")]))
    feature_argv = ["--checkpoint_dir", str(root / "mar"), "--val_data_dir",
                    str(data / "latent_val"), "--batch_size", "2", "--max_examples", "4",
                    "--maskgit_steps", "1", "--compute_fid", "--seed", "2", "--device", "cpu"]
    (root / "feature_argv.json").write_text(json.dumps(
        [*feature_argv, *tp, "--output_dir", str(root / "feat2")]))
    both = root / "fsdp_tp"  # (fsdp 2, tp 2): the discrete step alone, 4 ranks
    both.mkdir()
    (both / "cases.json").write_text(json.dumps(["discrete"]))
    procs = _start(root, 2, 1) + _start(both, 4, 2, ["--steps_only"])
    try:
        one_process = {case: train_case(spec) for case, spec in drawn.items()}
        one_rollouts = _one_process_rollouts(rollouts)
        want, placements = {}, {}
        spec, want["fsdp_tp"], placements["fsdp_tp"] = _jax_case(
            False, False, fsdp=2, tp=2, card=FSDP_TP)
        _save(spec, both / "discrete_case.pt")
        for case, (continuous, bf16, card) in CARDS.items():
            spec, want[case], placements[case] = _jax_case(continuous, bf16, fsdp=1, tp=2,
                                                           card=card)
            want[case]["state"] = spec["state"]
            _save(spec, root / f"{case}_case.pt")
        jax_losses = _jax_train(root, data, init, init_cfg, dp=1, tp=2)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DP_OK" in out, f"process {r}:\n{out[-6000:]}"
    # the tp run's step-2 checkpoint in one process
    train_main([*one_argv, "--output_dir", str(root / "one_from_tp"),
                "--resume_from_checkpoint", str(root / "port_a" / "step_2")])
    one = evaluate_main([*eval_argv, "--output_dir", str(root / "eval1"),
                         "--save_outputs_dir", str(root / "samples1")])
    one_feature = evaluate_feature_main([*feature_argv, "--output_dir", str(root / "feat1")])
    return dict(root=root, want=want, placements=placements, jax_losses=jax_losses,
                one_process_eval=one, one_process_feature=one_feature,
                one_process_steps=one_process, one_rollouts=one_rollouts)


@pytest.mark.parametrize("case", list(CARDS))
def test_tp_steps_match_jax_tp2_mesh(tp_run, case):
    want = tp_run["want"][case]
    ranks = _ranks(tp_run["root"], case)
    steps = len(want["losses"])
    _assert_state(ranks, want, REL, steps)
    got = ranks[0]
    assert got["domain_count"] == want["domain_count"] == [0, 1, int(steps == 2)]
    for r in ranks:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        assert all(m["skipped"] == 0.0 for m in r["metrics"])


def test_fsdp_tp_step_matches_jax_fsdp2_tp2_mesh(tp_run):
    """Four ranks as (fsdp 2, tp 2): each tp rank's parts sharded by FSDP2
    over the two ranks of its fsdp group, against hma_tpu's
    make_mesh(4, dp=1, fsdp=2, tp=2) step; each rank's shard has the shape
    hma_tpu gives its device."""
    want, placements = tp_run["want"]["fsdp_tp"], tp_run["placements"]["fsdp_tp"]
    ranks = _ranks(tp_run["root"] / "fsdp_tp", "discrete", 4)
    _assert_state(ranks, want, REL, 2)
    for r in ranks:
        assert r["domain_count"] == want["domain_count"] == [0, 1, 1]
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        for n, (dim, shard, size, dim_tp) in placements.items():
            assert r["tp_placements"][n][0] == dim_tp, n
            if dim is not None:
                assert r["placements"][n] == (dim, shard), (n, r["placements"][n], dim, shard)
    assert any(d is not None for d, *_ in placements.values())  # fsdp shards something


@pytest.mark.parametrize("case", ["discrete", "continuous"])
def test_tp_placements_follow_param_spec(tp_run, case):
    """Each rank's local shape and split dimension are hma_tpu's shard
    under param_spec at tp 2 (whole where it replicates); the parts
    gathered and un-dealt are the whole tensors bit for bit, and each part
    is its rank's dealt columns of the whole."""
    want = tp_run["placements"][case]
    state = tp_run["want"][case]["state"]
    ranks = _ranks(tp_run["root"], case)
    assert any(d is not None for *_, d in want.values())
    if case == "discrete":  # the 257-wide MLP stays whole, as param_spec leaves it
        mlp = [n for n in want if ".mlp." in n]
        assert mlp and all(want[n][3] is None for n in mlp)
    for rank, r in enumerate(ranks):
        got = r["tp_placements"]
        assert set(got) == set(want)
        for n, (_, shard, _, dim_tp) in want.items():
            assert got[n] == (dim_tp, shard), (n, got[n], dim_tp, shard)
        assert r["roundtrip_differs"] == []
        for n, local in r["local_initial"].items():
            part = tpar.Part(got[n][0], 3 if n.endswith("qkv.weight") else
                             2 if ".ada_fc2." in n else 1, tuple(state[n].shape))
            assert torch.equal(local, tpar.take(state[n], part, rank, 2)), n


@pytest.mark.parametrize("case", list(OWN_DRAWS))
def test_tp_ranks_drawing_their_own_equal_one_process(tp_run, case):
    """Nothing handed in: the two tp ranks draw what one process draws for
    the whole batch (the dropout's hidden mask at the whole width, sliced),
    so tp 2 takes the step one process takes."""
    one = tp_run["one_process_steps"][case]
    ranks = _ranks(tp_run["root"], case)
    _assert_state(ranks, one, ONE, 2)
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got["skipped"] == want["skipped"] == 0.0
            for k in ("loss", "action_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["discrete", "mar"])
def test_tp_rollouts_equal_one_process(tp_run, name):
    root, one = tp_run["root"], tp_run["one_rollouts"][name]
    for r in range(2):
        got = torch.load(root / f"rollouts_rank{r}.pt", weights_only=False)
        assert got[f"{name}_heads"] == 2  # H / tp heads in the caches
        if name == "discrete":
            assert torch.equal(got[name], one)
        else:
            torch.testing.assert_close(got[name], one, rtol=1e-5, atol=1e-5)


def test_tp_train_multi_matches_jax_and_checkpoints_cross(tp_run):
    root = tp_run["root"]
    ranks = [json.loads((root / f"train_rank{r}.json").read_text()) for r in range(2)]
    losses = [[m["loss"] for m in r["straight"]] for r in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], tp_run["jax_losses"], rtol=1e-5)
    assert [m["loss"] for m in ranks[0]["resumed"]] == losses[0][2:]
    assert ranks[0]["writers"] and set(ranks[0]["writers"]) == {0}
    assert ranks[1]["writers"] == []
    config = json.loads(open(root / "port_a" / "metrics.jsonl").readline())["_config"]
    assert (config["world_size"], config["tp"], config["sliced_grads_active"]) == (2, 2, False)

    def train_losses(run):
        return [json.loads(l)["train/loss"] for l in open(root / run / "metrics.jsonl")
                if "train/loss" in l]

    one = train_losses("port_one")
    np.testing.assert_allclose(one, losses[0], rtol=1e-5)
    np.testing.assert_allclose(train_losses("one_from_tp"), losses[0][2:], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in ranks[0]["from_one"]], one[2:], rtol=1e-5)
    # whole tensors in one process's layout
    for name in ("model.pt", "train_state.pt"):
        tp_ckpt, one_ckpt = (torch.load(root / run / "step_2" / name, weights_only=True)
                             for run in ("port_a", "port_one"))
        if name == "train_state.pt":
            tp_ckpt, one_ckpt = tp_ckpt["opt_state"]["m"], one_ckpt["opt_state"]["m"]
        assert {k: v.shape for k, v in tp_ckpt.items()} == \
            {k: v.shape for k, v in one_ckpt.items()}
        for k, v in tp_ckpt.items():
            torch.testing.assert_close(v, one_ckpt[k], rtol=1e-4, atol=1e-6)


def test_tp_evaluate_equals_one_process(tp_run):
    root, one = tp_run["root"], tp_run["one_process_eval"]
    ranks = [json.loads((root / f"eval_rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["jax_loaded"] == []
        assert "item 10e" in r["sliced_refused"]
        got = r["evaluate"]
        assert got["num_examples"] == one["num_examples"] == 8
        for k in ("loss", "perplexity", "acc"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)
    for lo in (0, 4):  # greedy samples: both ranks hold every row
        whole = np.load(root / "samples1" / f"pred_{lo}_r0.npy")
        for r in range(2):
            np.testing.assert_array_equal(np.load(root / "samples2" / f"pred_{lo}_r{r}.npy"),
                                          whole)
    feats, one_feature = [r["evaluate_feature"] for r in ranks], tp_run["one_process_feature"]
    timeless = [{k: v for k, v in f.items() if k != "gen_time"} for f in feats]
    assert timeless[0] == timeless[1]  # gen_time is each rank's own clock
    assert feats[0]["num_examples"] == one_feature["num_examples"] == 4
    for k in ("latent_mse", "latent_mse_per_frame", "fid_latent"):
        np.testing.assert_allclose(feats[0][k], one_feature[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# in this process

def test_dp2_tp2_groups_rank_by_rank():
    """(dp 2, tp 2) over four ranks in (dp, fsdp, tp, sp) order: the data
    group of rank r holds the ranks of its tp index, its tp group those of
    its data index, and the data helpers go by the data index (each rank of
    a fake process group, one at a time)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    idx = np.arange(8)
    for r in range(4):
        tdist.init_process_group("fake", store=FakeStore(), rank=r, world_size=4)
        try:
            mesh = port_mesh.make_mesh(dp=2, tp=2)
            assert tdist.get_process_group_ranks(port_mesh.data_group(mesh)) == [r % 2, r % 2 + 2]
            assert tdist.get_process_group_ranks(port_mesh.tp_group(mesh)) == \
                [r // 2 * 2, r // 2 * 2 + 1]
            assert (dist.data_index(), dist.data_count()) == (r // 2, 2)
            np.testing.assert_array_equal(dist.local_slice(idx), idx[r // 2 * 4:r // 2 * 4 + 4])
        finally:
            tdist.destroy_process_group()
    assert (dist.data_index(), dist.data_count()) == (0, 1)  # no group: one process


def test_dealt_columns_are_whole_heads_and_features():
    """qkv's (3, H, D) output dealt over tp 2 gives rank r q, k, v of heads
    [2r, 2r + 2) of 4, in (3, 2, D) order; ada_fc2's [shift | scale] the
    shift and scale of its features; a contiguous split its slice."""
    H, D = 4, 3
    for r in range(2):
        got = tpar.part_index(3 * H * D, 3, r, 2).reshape(3, 2, D)
        for j in range(3):
            for h in range(2):
                want = j * H * D + (2 * r + h) * D + np.arange(D)
                np.testing.assert_array_equal(got[j, h], want)
        np.testing.assert_array_equal(tpar.part_index(2 * 8, 2, r, 2),
                                      np.r_[4 * r:4 * r + 4, 8 + 4 * r:8 + 4 * r + 4])
        np.testing.assert_array_equal(tpar.part_index(8, 1, r, 2), np.arange(4 * r, 4 * r + 4))


def test_split_parts_and_whole_shape_rules():
    """A model split by `split_model` for each rank of tp 2 (no group: the
    split itself sends nothing): the parts of every split parameter dealt
    back together are its whole tensor bit for bit, `convert.params_from_jax`
    gives the same parts, and the muP mask, which compares shapes with the
    base model's, reads the whole shapes."""
    from hma_tpu_torch.convert import params_from_jax
    from hma_tpu_torch.train.step import mup_matrix_mask
    from hma_tpu_torch.train.trainer import mup_base_model

    card = tiny_card(num_heads=4, use_mup=True)
    whole = port_model(STMaskGIT, card, seed=21)
    state = whole.state_dict()
    base = mup_base_model(whole, whole.config)
    parts = []
    for r in range(2):
        model = port_model(STMaskGIT, card, seed=21)
        tpar.split_model(model, tpar.Group(None, r, 2))
        assert mup_matrix_mask(model, base) == mup_matrix_mask(whole, base)
        parts.append(model)
    split = parts[0].tp_parts
    assert {n.rpartition(".")[0].rpartition(".")[2] for n in split} >= {
        "qkv", "proj", "fc1", "fc2", "ada_fc1", "ada_fc2", "linear_out", "out_x_proj"}
    for n, part in split.items():
        local = [dict(m.named_parameters())[n].detach() for m in parts]
        joined = torch.cat(local, part.dim)
        idx = torch.cat([tpar.part_index(part.shape[part.dim], part.chunks, r, 2)
                         for r in range(2)])
        back = torch.empty_like(joined).index_copy_(part.dim, idx, joined)
        assert torch.equal(back, state[n]), n
    # hma_tpu's tree of the same weights, converted a rank's part at a time
    jcfg = JaxGenieConfig(**card)
    tok = jax.ShapeDtypeStruct((1, jcfg.T, jcfg.S), jnp.int32)
    shapes = jax.eval_shape(JaxSTMaskGIT(jcfg).init, {"params": jax.random.PRNGKey(0)}, tok,
                            tok, jax.ShapeDtypeStruct((1, jcfg.T, jcfg.max_d_action),
                                                      jnp.float32),
                            jax.ShapeDtypeStruct((), jnp.int32))
    tree = jax_tree_from_port(state, shapes, whole.config)
    for r, model in enumerate(parts):
        got = params_from_jax(tree, whole.config, tp=(r, 2))
        for n, p in model.state_dict().items():
            assert torch.equal(got[n], p), n
