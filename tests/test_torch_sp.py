"""sp (the mesh's "sp" axis: every frame's tokens split over sequence-
parallel ranks), port vs hma_tpu on the CPU: two gloo ranks, launched once
for the module as subprocesses (`tests/torch_dp_rank.py ROOT 1 1 2`; they
import no JAX), against hma_tpu's `make_mesh(2, dp=1, fsdp=1, tp=1, sp=2)`
over two of conftest's eight virtual CPU devices in this process, whose
`batch_sharding` splits the integer token batch's trailing axis over "sp".

- The sp 2 train step (both ranks on the whole global batch, the domain-
  sliced AdamW with full grads) equals hma_tpu's sp=2 step for both
  families with fp32 moments (params 1e-5, first moments 2e-5, second
  moments 4e-5 of max |want|, losses 1e-5 relative, as
  tests/test_torch_tp.py holds tp), and for one bf16-moment step with
  hma_tpu's stochastic-rounding bits recorded, under test_torch_fsdp's
  per-element bf16 rule.
- sp 2 drawing its own dropout (MLP dropout 0.1, the masks drawn at the
  whole frame and cut to the rank's tokens), action drops, diffusion noise
  and bf16 bits equals the port's one process: the joint cards of
  tests/test_torch_data_parallel.py (the discrete one over microbatches),
  the cross-attention card in the reference's compat mode (its row pairing
  reads the global token index) and the STMAR card in the resident layout.
- The cached discrete rollout at temperature 0 gives one process's greedy
  tokens, and `window_logits` over caches that `frame_logits` filled one
  process's logits; the cached MAR rollout with handed-in draws one
  process's latents; each rank's caches hold S_tot / sp sites of each row.
- `train_multi --sp 2` for 3 steps equals hma_tpu's `--sp 2` losses to
  1e-5 relative; its step-2 checkpoint (whole) resumes in one process, and
  one process's in sp 2.
- `evaluate --sp 2` (sampled at temperature 1) and `evaluate_feature --sp
  2` equal one process.
- Four ranks in one launch take one discrete step on each of two meshes: (fsdp 2,
  sp 2) against hma_tpu's `make_mesh(4, dp=1, fsdp=2, tp=1, sp=2)`, then
  (tp 2, sp 2) against `make_mesh(4, dp=1, fsdp=1, tp=2, sp=2)`.
- In this process: the groups that (dp 2, tp 2, sp 2) makes, rank by rank
  (a fake process group), and the token and head counts sp must divide.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.evaluate import main as evaluate_main
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
from hma_tpu_torch.models.attention import SelfAttention
from hma_tpu_torch.models.st_mar import STMAR
from hma_tpu_torch.models.st_mask_git import STMaskGIT
from hma_tpu_torch.parallel import distributed as dist
from hma_tpu_torch.parallel import mesh as port_mesh
from hma_tpu_torch.parallel import sequence_parallel as seqp
from hma_tpu_torch.parallel import tensor_parallel as tpar
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main
from hma_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_data_parallel import (
    ONE,
    REL,
    _domains,
    _free_port,
    _initial_weights,
    _jax_train,
    _save,
    _train_argv,
    _write_data,
)
from test_torch_fsdp import _assert_state, _jax_case, _ranks
from test_torch_tp import _one_process_rollouts, _own_case, _rollout_cases
from torch_dp_rank import train_case, window
from torch_port_helpers import port_model, tiny_card, tiny_mar_card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 4 heads of 16 (2 a rank at the exchange, 1 under tp 2 as well), 16 image
# and 8 action tokens (12 a rank)
DISC = tiny_card(num_layers=1, d_model=64, num_heads=4, qk_norm=True)
CARDS = {"discrete": (False, False, DISC),
         "discrete_bf16": (False, True, DISC),
         "continuous": (True, False, tiny_mar_card(num_layers=1, num_heads=4, qk_norm=True,
                                                   diffloss_w=256))}
# the cases that draw their own: (dp test case or a card, moments, layout)
OWN_DRAWS = {"discrete_drawn": ("discrete_drawn", None, "transpose"),
             "continuous_drawn_bf16": ("continuous_drawn", "bfloat16", "transpose"),
             "continuous_resident_drawn": ("continuous_drawn", None, "resident"),
             "cross_reference_drawn": (tiny_card(
                 num_layers=1, action_network="concat+cross_attention",
                 cross_attention_compat="reference", qk_norm=True,
                 jointly_predict_actions=True, mlp_drop=0.1), None, "transpose")}
# the four-rank launch's two meshes: {case directory: (fsdp, tp, sp)}
FOUR = {"fsdp_sp": (2, 1, 2), "tp_sp": (1, 2, 2)}


def _start(root, world: int, factors, extra=()) -> list:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HMA_TPU_", "XLA_", "JAX_"))}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_rank.py"), str(root),
         *map(str, factors), *extra],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """Everything the module compares, made once: one process's 2-step run
    first (its step-2 checkpoint is what the ranks' third run resumes
    from), then the two sp ranks and the four ranks of the two meshes,
    which take the step cases once this process has written them; hma_tpu's
    sides and one process's run here meanwhile."""
    root = tmp_path_factory.mktemp("sp")
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
    sp = ["--sp", "2"]
    (root / "train_argv.json").write_text(json.dumps([*argv, *sp]))
    (root / "cases.json").write_text(json.dumps([*OWN_DRAWS, *CARDS]))
    drawn = {case: {**_own_case(base, moments), "temporal_layout": layout}
             for case, (base, moments, layout) in OWN_DRAWS.items()}
    for case, spec in drawn.items():
        _save(spec, root / f"{case}_case.pt")
    rollouts = _rollout_cases()
    _save(rollouts, root / "rollouts.pt")
    eval_argv = ["--checkpoint_dir", str(root / "port_one" / "final_checkpt"),
                 "--val_data_dir", str(data / "language_table_magvit_max1000000_val"),
                 "--batch_size", "4", "--max_examples", "8", "--temperature", "1.0",
                 "--seed", "5", "--device", "cpu"]
    (root / "eval_argv.json").write_text(json.dumps(
        [*eval_argv, *sp, "--output_dir", str(root / "eval2"), "--save_outputs_dir",
         str(root / "samples2")]))
    feature_argv = ["--checkpoint_dir", str(root / "mar"), "--val_data_dir",
                    str(data / "latent_val"), "--batch_size", "2", "--max_examples", "4",
                    "--maskgit_steps", "1", "--compute_fid", "--seed", "2", "--device", "cpu"]
    (root / "feature_argv.json").write_text(json.dumps(
        [*feature_argv, *sp, "--output_dir", str(root / "feat2")]))
    for name in FOUR:  # the discrete step alone on each four-rank mesh
        (root / name).mkdir()
        (root / name / "cases.json").write_text(json.dumps(["discrete"]))
    (fsdp, tp, s), also = FOUR["fsdp_sp"], FOUR["tp_sp"]
    procs = _start(root, 2, (1, 1, 2)) + _start(
        root / "fsdp_sp", 4, (fsdp, tp, s),
        ["--steps_only", "--also", str(root / "tp_sp"), *map(str, also)])
    try:
        one_process = {case: train_case(spec) for case, spec in drawn.items()}
        one_rollouts = _one_process_rollouts(rollouts)
        model = STMaskGIT(GenieConfig(**rollouts["discrete"]["card"]), dtype=torch.float32,
                          device="cpu")
        model.load_state_dict(rollouts["discrete"]["state"])
        with torch.no_grad():
            one_rollouts["window"] = window(model.eval(), rollouts["discrete"])
        want, placements = {}, {}
        for name, (fsdp, tp, s) in FOUR.items():
            spec, want[name], placements[name] = _jax_case(False, False, fsdp=fsdp, tp=tp,
                                                           sp=s, card=DISC, steps=1)
            _save(spec, root / name / "discrete_case.pt")
        for case, (continuous, bf16, card) in CARDS.items():
            spec, want[case], _ = _jax_case(continuous, bf16, fsdp=1, sp=2, card=card)
            _save(spec, root / f"{case}_case.pt")
        jax_losses = _jax_train(root, data, init, init_cfg, dp=1, sp=2)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DP_OK" in out, f"process {r}:\n{out[-6000:]}"
    # the sp run's step-2 checkpoint in one process
    train_main([*one_argv, "--output_dir", str(root / "one_from_sp"),
                "--resume_from_checkpoint", str(root / "port_a" / "step_2")])
    one = evaluate_main([*eval_argv, "--output_dir", str(root / "eval1"),
                         "--save_outputs_dir", str(root / "samples1")])
    one_feature = evaluate_feature_main([*feature_argv, "--output_dir", str(root / "feat1")])
    return dict(root=root, want=want, placements=placements, jax_losses=jax_losses,
                one_process_eval=one, one_process_feature=one_feature,
                one_process_steps=one_process, one_rollouts=one_rollouts)


@pytest.mark.parametrize("case", list(CARDS))
def test_sp_steps_match_jax_sp2_mesh(sp_run, case):
    want = sp_run["want"][case]
    ranks = _ranks(sp_run["root"], case)
    steps = len(want["losses"])
    _assert_state(ranks, want, REL, steps)
    got = ranks[0]
    assert got["domain_count"] == want["domain_count"] == [0, 1, int(steps == 2)]
    assert "placements" not in got and "tp_placements" not in got  # sp holds whole tensors
    for r in ranks:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        assert all(m["skipped"] == 0.0 for m in r["metrics"])


@pytest.mark.parametrize("mesh", list(FOUR))
def test_four_rank_sp_step_matches_jax_mesh(sp_run, mesh):
    """Four ranks as (fsdp 2, sp 2), FSDP2 over the two ranks of each fsdp
    group and the sum over sp on its shards, then as (tp 2, sp 2), the
    exchange over H / tp heads, each against hma_tpu's mesh of the same
    factors; under fsdp each rank's shard has the shape hma_tpu gives its
    device, under tp its part is split on hma_tpu's dimension."""
    want, placements = sp_run["want"][mesh], sp_run["placements"][mesh]
    ranks = _ranks(sp_run["root"] / mesh, "discrete", 4)
    _assert_state(ranks, want, REL, 1)
    for r in ranks:
        assert r["domain_count"] == want["domain_count"] == [0, 1, 0]
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], want["losses"],
                                   rtol=1e-5)
        for n, (dim, shard, _, dim_tp) in placements.items():
            if mesh == "fsdp_sp" and dim is not None:
                assert r["placements"][n] == (dim, shard), (n, r["placements"][n], dim, shard)
            if mesh == "tp_sp":
                assert r["tp_placements"][n] == (dim_tp, shard), n
    split = {"fsdp_sp": 0, "tp_sp": 3}[mesh]  # the placements' fsdp or tp dimension
    assert any(p[split] is not None for p in placements.values())


@pytest.mark.parametrize("case", list(OWN_DRAWS))
def test_sp_ranks_drawing_their_own_equal_one_process(sp_run, case):
    """Nothing handed in: the two sp ranks draw what one process draws for
    the whole batch (the dropout masks at the whole frame, cut to each
    rank's tokens), so sp 2 takes the step one process takes."""
    one = sp_run["one_process_steps"][case]
    ranks = _ranks(sp_run["root"], case)
    _assert_state(ranks, one, ONE, 2)
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got["skipped"] == want["skipped"] == 0.0
            for k in ("loss", "action_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["discrete", "mar"])
def test_sp_rollouts_equal_one_process(sp_run, name):
    root, one = sp_run["root"], sp_run["one_rollouts"][name]
    whole = {"discrete": 16 + 8, "mar": 4 + 8}[name]  # S_tot: image (patch) + action tokens
    for r in range(2):
        got = torch.load(root / f"rollouts_rank{r}.pt", weights_only=False)
        assert got[f"{name}_sites"] == whole // 2  # a rank's sites of a row
        assert got[f"{name}_heads"] == 4  # every head: sp splits tokens, not heads
        if name == "discrete":
            assert torch.equal(got[name], one)
            torch.testing.assert_close(got["window"], sp_run["one_rollouts"]["window"],
                                       rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(got[name], one, rtol=1e-5, atol=1e-5)


def test_sp_train_multi_matches_jax_and_checkpoints_cross(sp_run):
    root = sp_run["root"]
    ranks = [json.loads((root / f"train_rank{r}.json").read_text()) for r in range(2)]
    losses = [[m["loss"] for m in r["straight"]] for r in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], sp_run["jax_losses"], rtol=1e-5)
    assert [m["loss"] for m in ranks[0]["resumed"]] == losses[0][2:]
    assert ranks[0]["writers"] and set(ranks[0]["writers"]) == {0}
    assert ranks[1]["writers"] == []
    config = json.loads(open(root / "port_a" / "metrics.jsonl").readline())["_config"]
    assert (config["world_size"], config["sp"], config["sliced_grads_active"]) == (2, 2, False)

    def train_losses(run):
        return [json.loads(l)["train/loss"] for l in open(root / run / "metrics.jsonl")
                if "train/loss" in l]

    one = train_losses("port_one")
    np.testing.assert_allclose(one, losses[0], rtol=1e-5)
    np.testing.assert_allclose(train_losses("one_from_sp"), losses[0][2:], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in ranks[0]["from_one"]], one[2:], rtol=1e-5)
    for name in ("model.pt", "train_state.pt"):
        sp_ckpt, one_ckpt = (torch.load(root / run / "step_2" / name, weights_only=True)
                             for run in ("port_a", "port_one"))
        if name == "train_state.pt":
            sp_ckpt, one_ckpt = sp_ckpt["opt_state"]["m"], one_ckpt["opt_state"]["m"]
        assert {k: v.shape for k, v in sp_ckpt.items()} == \
            {k: v.shape for k, v in one_ckpt.items()}
        for k, v in sp_ckpt.items():
            torch.testing.assert_close(v, one_ckpt[k], rtol=1e-4, atol=1e-6)


def test_sp_evaluate_equals_one_process(sp_run):
    root, one = sp_run["root"], sp_run["one_process_eval"]
    ranks = [json.loads((root / f"eval_rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["jax_loaded"] == []
        assert "item 10e" in r["sliced_refused"]
        got = r["evaluate"]
        assert got["num_examples"] == one["num_examples"] == 8
        for k in ("loss", "perplexity", "acc"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)
    for lo in (0, 4):  # sampled at temperature 1: both ranks hold every row
        whole = np.load(root / "samples1" / f"pred_{lo}_r0.npy")
        for r in range(2):
            np.testing.assert_array_equal(np.load(root / "samples2" / f"pred_{lo}_r{r}.npy"),
                                          whole)
    feats, one_feature = [r["evaluate_feature"] for r in ranks], sp_run["one_process_feature"]
    timeless = [{k: v for k, v in f.items() if k != "gen_time"} for f in feats]
    assert timeless[0] == timeless[1]  # gen_time is each rank's own clock
    assert feats[0]["num_examples"] == one_feature["num_examples"] == 4
    for k in ("latent_mse", "latent_mse_per_frame", "fid_latent"):
        np.testing.assert_allclose(feats[0][k], one_feature[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# in this process

def test_dp2_tp2_sp2_groups_rank_by_rank():
    """(dp 2, tp 2, sp 2) over eight ranks in (dp, fsdp, tp, sp) order: the
    sp group of rank r holds the ranks of its data and tp index, its tp
    group those of its data and sp index, its data group those of its tp and
    sp index, the group an unsharded model's gradients are summed over
    those of its tp index, and the data helpers go by the data index (each rank of a
    fake process group, one at a time)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    idx = np.arange(8)
    for r in range(8):
        tdist.init_process_group("fake", store=FakeStore(), rank=r, world_size=8)
        try:
            mesh = port_mesh.make_mesh(dp=2, tp=2, sp=2)
            ranks = tdist.get_process_group_ranks
            assert ranks(port_mesh.sp_group(mesh)) == [r // 2 * 2, r // 2 * 2 + 1]
            assert ranks(port_mesh.tp_group(mesh)) == [r // 4 * 4 + r % 2, r // 4 * 4 + r % 2 + 2]
            assert ranks(port_mesh.data_group(mesh)) == [r % 4, r % 4 + 4]
            assert (dist.data_index(), dist.data_count()) == (r // 4, 2)
            np.testing.assert_array_equal(dist.local_slice(idx), idx[r // 4 * 4:r // 4 * 4 + 4])
            tp_index = r // 2 % 2
            assert ranks(port_mesh.grad_group(mesh)) == [2 * tp_index + i for i in (0, 1, 4, 5)]
            sp = tpar.group_of(port_mesh.sp_group(mesh))
            assert (sp.rank, sp.size) == (r % 2, 2)
            assert torch.equal(seqp.split_tokens(torch.arange(24), sp, 0),
                               torch.arange(12 * (r % 2), 12 * (r % 2) + 12))
        finally:
            tdist.destroy_process_group()
    assert (dist.data_index(), dist.data_count()) == (0, 1)  # no group: one process


def test_sp_refuses_what_it_cannot_split():
    """A token count (image plus action tokens) or a head count that sp does
    not divide raises where `hma_tpu` leaves the tokens whole (its
    batch_sharding replicates them); the split itself is a narrow of whole
    tokens, and no group is the identity."""
    sp = tpar.Group(None, 1, 5)
    with pytest.raises(NotImplementedError, match="does not divide the 24 tokens"):
        seqp.local_count(24, sp)
    with pytest.raises(NotImplementedError, match="does not divide the 4 heads"):
        SelfAttention(4, 32, device="cpu").enable_sp(sp)
    x = torch.arange(2 * 3 * 25).reshape(2, 3, 25)
    assert torch.equal(seqp.split_tokens(x, sp, 2), x[:, :, 5:10])
    assert seqp.split_tokens(x, None, 2) is x and seqp.gather_tokens(x, None, 2) is x
    model = port_model(STMaskGIT, tiny_card(num_heads=4), seed=1)
    seqp.enable(model, tpar.Group(None, 0, 2))
    assert model.sp.size == 2 and model.decoder.layers[0].spatial_attn.sp.size == 2
    # a rank's sites of each row: with the 8 action tokens, and without
    assert model.init_cache(3)[0].shape[1] == 3 * 24 // 2
    assert model.init_cache(3, with_actions=False)[0].shape[1] == 3 * 16 // 2
