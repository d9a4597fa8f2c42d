"""Rank process of tests/test_torch_data_parallel.py, tests/test_torch_fsdp.py,
tests/test_torch_tp.py and tests/test_torch_sp.py (not a test module).

Launched twice with torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) as `torch_dp_rank.py ROOT [FSDP [TP [SP]]]`: each
process joins the gloo group through
`hma_tpu_torch.parallel.distributed.init_distributed(device="cpu")`, makes
the (dp, fsdp, tp, sp) mesh with fsdp FSDP, tp TP and sp SP (default 1
each: data parallelism alone; the flags in ROOT's argv files say the same;
dp is the rest of the world), then (all but 3 with `--steps_only`, launched
as any number of processes; `--also ROOT2 FSDP2 TP2 SP2` then takes ROOT2's
step cases on a second mesh)

  1. runs `train_multi` for 3 steps from the test's initial weights, then
     again resumed from its step-2 checkpoint, recording every step's
     metrics and which ranks wrote checkpoints;
  2. runs `evaluate` and `evaluate_feature` over the two ranks;
  3. runs the port's train step on its rows of the global batches of
     `<case>_case.pt` (`train_case`; the cases `cases.json` names, by
     default both families with hma_tpu's draws handed in, the discrete
     case with sliced gradients, once the test has written them, and both
     families drawing their own dropout, action drops and diffusion noise),
     on a model sharded by FSDP2 under fsdp, split under tp and on the
     rank's tokens under sp, and saves its parameters and moments (gathered
     whole) and, sharded or split, each parameter's placement;
  4. with `rollouts.pt` in ROOT, runs the cached rollouts it names (the
     discrete greedy one and the MAR one with handed-in draws) on the model
     placed on the mesh, and saves their outputs and the caches' shapes;

and saves what the test compares. It imports no JAX.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig  # noqa: E402
from hma_tpu_torch.evaluate import main as evaluate_main  # noqa: E402
from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main  # noqa: E402
from hma_tpu_torch.models.st_mar import STMAR  # noqa: E402
from hma_tpu_torch.models.st_mask_git import STMaskGIT  # noqa: E402
from hma_tpu_torch.parallel import distributed as dist  # noqa: E402
from hma_tpu_torch.parallel.mesh import make_mesh, shard_model  # noqa: E402
from hma_tpu_torch.rollout.mar import generate_latents  # noqa: E402
from hma_tpu_torch.rollout.maskgit import generate_tokens  # noqa: E402
from hma_tpu_torch.train import step as port_step  # noqa: E402
from hma_tpu_torch.train import trainer  # noqa: E402
from hma_tpu_torch.train_multi import main as train_main  # noqa: E402
from hma_tpu_torch.utils.checkpoint import gather_state  # noqa: E402

LR, WD, EPS = 3e-3, 0.05, 1e-3


def _rows_of(draw: torch.Tensor, rows: np.ndarray, B: int, mul: int) -> torch.Tensor:
    """This rank's rows of a diffusion draw over the (mul, B, T*S') patch
    rows of the global batch."""
    rest = draw.shape[1:]
    return draw.reshape(mul, B, -1, *rest)[:, rows].reshape(-1, *rest)


def train_case(spec: dict, group=None, mesh=None) -> dict:
    """The port's train step over `spec`'s global batches on this rank's
    rows (every row without a group): the domain-sliced AdamW with
    `spec["moment_dtype"]` moments (fp32 by default), sliced gradients on
    the discrete card unless `spec["sliced"]` says otherwise,
    `spec["draws"]` and the moments' bits `spec["noise"]` handed in where
    there are some, grad accumulation over microbatches of
    `spec["microbatch"]` global rows where it is set (a rank takes its rows
    of each), the temporal layout `spec["temporal_layout"]` (default
    "transpose"). With a `mesh` whose fsdp, tp or sp is above 1 the model is
    split over tp, set on the rank's tokens under sp and sharded by FSDP2
    (`shard_model`). Returns the parameters and
    moments (whole), the counts, every step's metrics and, sharded or
    split, {name: (fsdp shard dim or None, local shape, tp split dim or
    None)}."""
    continuous = spec["continuous"]
    cls, cfg_cls = (STMAR, DiffusionGenieConfig) if continuous else (STMaskGIT, GenieConfig)
    cfg = cfg_cls(**spec["card"])
    model = cls(cfg, dtype=torch.float32, device="cpu",
                temporal_layout=spec.get("temporal_layout", "transpose"))
    model.load_state_dict(spec["state"])
    more = cfg_cls(**spec["card_more"])
    stacked = port_step.domain_stacked_mask(model, cls(more, dtype=torch.float32,
                                                       device="meta"))
    sharded = (mesh is not None
               and mesh["fsdp"].size() * mesh["tp"].size() * mesh["sp"].size() > 1)
    split = {}
    if sharded:
        shard_model(model, mesh)
        if getattr(model, "tp", None) is not None:  # the parts, and the whole again
            params = {n: p.detach() for n, p in model.named_parameters()}
            whole = gather_state(params, model.tp, model.tp_parts)
            split = {"roundtrip_differs": [n for n, t in whole.items()
                                           if not torch.equal(t, spec["state"][n])]}
            if mesh["fsdp"].size() == 1:
                split["local_initial"] = {n: params[n].clone() for n in model.tp_parts}
    tx = port_step.make_domain_sliced_optimizer(
        model, port_step.custom_cosine_schedule(LR, 1, 10), WD, eps=EPS,
        stacked_mask=stacked, num_domains=cfg.num_domains,
        moment_dtype=spec.get("moment_dtype"))
    world = 1 if group is None else dist.data_count()
    mb = spec.get("microbatch", 0)
    sliced = spec.get("sliced", not continuous)
    step = port_step.make_train_step(
        model, tx, microbatch=mb // world, continuous=continuous,
        action_loss_weight=cfg.action_loss_weight,
        stacked_mask=stacked if sliced else None, group=group)
    metrics = []
    for i, batch in enumerate(spec["batches"]):
        B = batch["input_ids"].shape[0]
        chunks = np.arange(B).reshape(-1, mb or B)  # a rank's rows of each microbatch
        rows = (np.arange(B) if group is None
                else np.concatenate([dist.local_slice(c) for c in chunks]))
        local = {k: (v[rows] if torch.is_tensor(v) else v) for k, v in batch.items()}
        draws = None
        if spec.get("draws"):
            draws = {k: _rows_of(v, rows, B, cfg.diffusion_batch_mul)
                     for k, v in spec["draws"][i].items()}
        noise = spec["noise"][i] if spec.get("noise") else None
        metrics.append({k: float(v) for k, v in
                        step(local, rng=i, draws=draws, noise=noise).items()})
    tp = (getattr(model, "tp", None), getattr(model, "tp_parts", None))
    out = {"params": gather_state({n: p.detach() for n, p in model.named_parameters()}, *tp),
           **gather_state({"m": tx.m, "v": tx.v}, *tp),
           "count": tx.count, "domain_count": tx.domain_count, "metrics": metrics,
           **split}
    if sharded and mesh["fsdp"].size() > 1:
        out["placements"] = {n: (p.placements[-1].dim, tuple(p.to_local().shape))
                             for n, p in model.named_parameters()}
    if tp[0] is not None:
        out["tp_placements"] = {n: (tp[1][n].dim if n in tp[1] else None,
                                    tuple(p.to_local().shape if hasattr(p, "to_local")
                                          else p.shape))
                                for n, p in model.named_parameters()}
    return out


def run_case(root: Path, case: str, group, mesh=None) -> None:
    path = root / f"{case}_case.pt"
    deadline = time.monotonic() + 600
    while not path.exists():  # the test writes it while this rank trains
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    torch.save(train_case(torch.load(path, weights_only=False), group, mesh),
               root / f"{case}_rank{dist.process_index()}.pt")


def run_train_multi(root: Path) -> None:
    """The straight 3-step run and the run resumed from its step 2, both
    from the test's initial weights, and, where the test wrote one, a run
    resumed from `port_one/step_2` (one process's checkpoint); every step's
    metrics on this rank and the ranks that wrote checkpoints."""
    init = torch.load(root / "init.pt", weights_only=True)

    class Loaded(STMaskGIT):
        """The trainer's model with the test's initial weights (the meta
        probes it builds stay meta)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if kw.get("device") != "meta":
                self.load_state_dict(init)

    trainer.STMaskGIT = Loaded
    seen, writers = [], []
    make_step, save = trainer.make_train_step, trainer.save_checkpoint

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            seen.append({k: float(v) for k, v in out.items()})
            return out
        return run

    def recording_save(*a, **kw):
        writers.append(dist.process_index())
        return save(*a, **kw)

    trainer.make_train_step, trainer.save_checkpoint = recording_step, recording_save
    argv = json.loads((root / "train_argv.json").read_text())
    train_main([*argv, "--output_dir", str(root / "port_a")])
    straight = list(seen)
    seen.clear()
    train_main([*argv, "--output_dir", str(root / "port_b"),
                "--resume_from_checkpoint", str(root / "port_a" / "step_2")])
    resumed = list(seen)
    seen.clear()
    if (root / "port_one" / "step_2").is_dir():
        train_main([*argv, "--output_dir", str(root / "port_c"),
                    "--resume_from_checkpoint", str(root / "port_one" / "step_2")])
    (root / f"train_rank{dist.process_index()}.json").write_text(json.dumps(
        {"straight": straight, "resumed": resumed, "from_one": seen, "writers": writers}))


def window(model, case) -> torch.Tensor:
    """`window_logits` of frames 2 and 3 of the discrete rollout case's
    tokens over caches filled with frames 0 and 1 by `frame_logits`."""
    k, v = model.init_cache(case["tokens"].shape[0])
    for t in range(2):
        _, k, v = model.frame_logits(case["tokens"][:, t], t, k, v, case["actions"])
    return model.window_logits(case["tokens"][:, 2:], 2, k, v, case["actions"])[0]


def run_rollouts(root: Path, mesh) -> None:
    """The rollouts of `rollouts.pt` on the model split over the mesh: the
    discrete greedy rollout (and `window`'s logits) and the MAR one with
    handed-in draws."""
    spec = torch.load(root / "rollouts.pt", weights_only=False)
    out = {}
    for name, case in spec.items():
        continuous = name == "mar"
        cls, cfg_cls = (STMAR, DiffusionGenieConfig) if continuous else (STMaskGIT, GenieConfig)
        model = cls(cfg_cls(**case["card"]), dtype=torch.float32, device="cpu")
        model.load_state_dict(case["state"])
        shard_model(model.eval(), mesh)
        g = dist.rank_rows(torch.Generator().manual_seed(0), dist.data_group())
        with torch.no_grad():
            if continuous:
                out[name] = generate_latents(model, case["latents"], 2, case["actions"], 0,
                                             g, draws=case["draws"])
            else:
                out[name] = generate_tokens(model, case["tokens"], 2, case["actions"], 0,
                                            g, maskgit_steps=2, temperature=0.0)
                out["window"] = window(model, case)
        out[f"{name}_heads"] = model.init_cache(1)[0].shape[-2]
        out[f"{name}_sites"] = model.init_cache(1)[0].shape[1]
    torch.save(out, root / f"rollouts_rank{dist.process_index()}.pt")


def main():
    root = Path(sys.argv[1])
    fsdp = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    tp = int(sys.argv[3]) if len(sys.argv) > 3 and sys.argv[3].isdigit() else 1
    sp = int(sys.argv[4]) if len(sys.argv) > 4 and sys.argv[4].isdigit() else 1
    assert dist.init_distributed(device="cpu")
    out = {}
    if "--steps_only" not in sys.argv:  # else only the step cases, any world
        assert dist.process_count() == 2
        run_train_multi(root)
        out = {"evaluate": evaluate_main(json.loads((root / "eval_argv.json").read_text())),
               "evaluate_feature": evaluate_feature_main(
                   json.loads((root / "feature_argv.json").read_text()))}
    mesh = make_mesh(fsdp=fsdp, tp=tp, sp=sp)
    if (root / "rollouts.pt").exists():
        run_rollouts(root, mesh)
    cases = root / "cases.json"
    cases = (json.loads(cases.read_text()) if cases.exists() else
             ("discrete_drawn", "continuous_drawn", "discrete", "continuous"))
    for case in cases:
        run_case(root, case, dist.data_group(), mesh)
    if fsdp * tp * sp > 1:  # sliced gradients on a sharded model raise (ROADMAP item 10e)
        spec = torch.load(root / f"{cases[0]}_case.pt", weights_only=False)
        try:
            train_case({**spec, "sliced": True}, dist.data_group(), mesh)
        except NotImplementedError as e:
            out["sliced_refused"] = str(e)
    if "--also" in sys.argv:  # a second mesh's step cases, from ROOT2
        root2, *factors = sys.argv[sys.argv.index("--also") + 1:][:4]
        mesh2 = make_mesh(**dict(zip(("fsdp", "tp", "sp"), map(int, factors))))
        for case in json.loads((Path(root2) / "cases.json").read_text()):
            run_case(Path(root2), case, dist.data_group(), mesh2)
    out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hma_tpu"))
    (root / f"eval_rank{dist.process_index()}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("DP_OK")


if __name__ == "__main__":
    main()
