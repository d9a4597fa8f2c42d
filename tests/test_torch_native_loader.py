"""The port's C++ native loader against hma_tpu's, on the CPU: the library is
built from the port's own copy of the source into build/ (never cpp/), and
loads beside hma_tpu's library in one process; for the same (seed, i), with 1 and 4
threads and from a `start_batch`, `NativeTokenLoader` and
`NativeFeatureLoader` give hma_tpu's batches; without a compiler it raises.
`train_multi --use_native_loader` trains both families from the loaders, a
resumed run ends bit for bit where a straight run does, and with
`drop_action_ratio` > 0 or `--overfit_first_batch` the Python assembler
serves the batches, as in hma_tpu. The trainer's loop around the loaders,
its steps made no-ops in both packages, makes hma_tpu's loaders (paths,
effective batch, seeds, action widths, start batches) and draws hma_tpu's
domains, straight and resumed across epochs."""

import ctypes
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from hma_tpu.config import GenieConfig as JaxGenieConfig
from hma_tpu.data import native_loader as jax_native_loader
from hma_tpu_torch.config import DiffusionGenieConfig, GenieConfig
from hma_tpu_torch.data import native_loader
from hma_tpu_torch.data.datasets import write_token_dataset
from hma_tpu_torch.train import trainer
from hma_tpu_torch.train_multi import main as train_main

ROOT = Path(__file__).resolve().parent.parent
CARD = dict(num_layers=1, num_heads=1, d_model=8, T=4, S=16, image_vocab_size=2**18,
            num_factored_vocabs=2, num_prompt_frames=2, use_actions=True)
DOMAINS = ("language_table", "bridge")  # loader strides 1 and 2 from the freq table


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    segs = np.repeat(np.arange(10), 20).astype(np.int32)
    write_token_dataset(root / "tok", rng.integers(0, 2**18, (200, 4, 4)).astype(np.uint32),
                        segs, rng.normal(size=(200, 3)).astype(np.float32),
                        {"name": "language_table"})
    write_token_dataset(root / "lat", (2 * rng.normal(size=(200, 4, 4, 4))).astype(np.float16),
                        segs, rng.normal(size=(200, 3)).astype(np.float32),
                        {"name": "language_table", "latent_channels": 4})
    return root


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """hma_tpu's library. Unless this process has it already, it is built
    from a copy of cpp/hma_loader.cpp in a directory of its own: hma_tpu
    builds in place, without a lock, and tests/test_native_loader.py may be
    building cpp/libhma_loader.so in another worker."""
    if jax_native_loader._LIB is None:
        src = tmp_path_factory.mktemp("jax_cpp")
        shutil.copy(ROOT / "cpp" / "hma_loader.cpp", src / "hma_loader.cpp")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_native_loader, "_CPP_DIR", src)
            return jax_native_loader._load_library()
    return jax_native_loader._load_library()


def test_library_is_built_into_build_from_the_ports_source(jax_lib):
    lib = native_loader._load_library()
    path = Path(lib._name)
    assert path == native_loader.library_path() and path.is_file()
    assert path.parent == ROOT / "build" / "hma_tpu_torch"
    assert native_loader.SOURCE == ROOT / "hma_tpu_torch" / "cpp" / "hma_loader.cpp"
    # hma_tpu's library loads beside it: two handles (RTLD_LOCAL), each
    # resolving its own symbols
    assert Path(jax_lib._name).parent != path.parent
    assert lib._handle != jax_lib._handle
    own = ctypes.cast(lib.hma_loader_create, ctypes.c_void_p).value
    theirs = ctypes.cast(jax_lib.hma_loader_create, ctypes.c_void_p).value
    assert own != theirs


def test_without_a_compiler_it_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.NativeTokenLoader(str(tmp_path), GenieConfig(**CARD), 4)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("threads,start", [(1, 0), (4, 0), (2, 5)])
@pytest.mark.parametrize("kind", ["token", "feature"])
def test_batches_equal_jax(datasets, jax_lib, kind, threads, start):
    if kind == "token":
        ours, theirs, d = (native_loader.NativeTokenLoader,
                           jax_native_loader.NativeTokenLoader, "tok")
        cfg, jcfg = GenieConfig(**CARD), JaxGenieConfig(**CARD)
    else:
        ours, theirs, d = (native_loader.NativeFeatureLoader,
                           jax_native_loader.NativeFeatureLoader, "lat")
        card = dict(CARD, dataloader_mask_ratio_min=0.1, non_mlm_ratio=0.5)
        cfg, jcfg = GenieConfig(**card), JaxGenieConfig(**card)
    ref = theirs(str(datasets / d), jcfg, batch_size=4, seed=7, num_threads=1, action_width=5)
    want = [ref.next_batch() for _ in range(start + 4)]
    ref.close()
    got = ours(str(datasets / d), cfg, batch_size=4, seed=7, num_threads=threads,
               action_width=5, start_batch=start)
    assert got.num_windows() > 0 and got.stride == 1
    for k in range(start, start + 4):
        _same(got.next_batch(), want[k])
    got.close()


@pytest.fixture(scope="module")
def train_env(tmp_path_factory):
    """Two domains of tokens and of latents, train and val, and the two tiny
    cards (1 layer)."""
    root = tmp_path_factory.mktemp("native_train")
    data = root / "data"
    rng = np.random.default_rng(2)
    for d, domain in enumerate(DOMAINS):
        for split, n in (("train", 80), ("val", 40)):
            segs = np.repeat(np.arange(n // 10), 10)
            acts = rng.normal(size=(n, 2 + d)).astype(np.float32)
            write_token_dataset(data / f"{domain}_magvit_max1000000_{split}",
                                rng.integers(0, 2**18, (n, 4, 4)).astype(np.uint32), segs,
                                acts, {"name": domain, "vocab_size": 2**18, "s": 16})
            write_token_dataset(data / f"{domain}_vae_max1000000_{split}",
                                rng.normal(size=(n, 4, 4, 4)).astype(np.float16), segs,
                                acts, {"name": domain, "latent_channels": 4})
    common = dict(num_layers=1, num_heads=2, d_model=32, T=4, S=16, action_token_size=8,
                  action_network="concat+modulate", num_prompt_frames=2, use_actions=True)
    GenieConfig(image_vocab_size=2**18, num_factored_vocabs=2, **common).save_pretrained(
        str(root / "discrete.json"))
    GenieConfig(image_vocab_size=2**18, num_factored_vocabs=2, drop_action_ratio=0.1,
                **common).save_pretrained(str(root / "drop.json"))
    DiffusionGenieConfig(vae_embed_dim=4, patch_size=2, diffloss_d=2, diffloss_w=64,
                         num_sampling_steps="4", maskgit_steps=2, mlp_drop=0.1,
                         **common).save_pretrained(str(root / "continuous.json"))
    (root / "split.yaml").write_text(yaml.safe_dump({"domains": ",".join(DOMAINS)}))
    return root, data


def _argv(root, data, out, card, *extra):
    return ["--genie_config", str(root / card), "--output_dir", str(out),
            "--train_split", str(root / "split.yaml"), "--data_root", str(data),
            "--window_size", "4", "--per_device_train_batch_size", "4",
            "--per_device_eval_batch_size", "2", "--learning_rate", "3e-3",
            "--eval_every_n_steps", "100", "--max_eval_steps", "1",
            "--checkpointing_steps", "3", "--num_warmup_steps", "1", "--log_every", "1",
            "--seed", "5", "--use_native_loader", "--device", "cpu", *extra]


@pytest.fixture
def spy(monkeypatch):
    """Records the domains of every native batch the trainer takes."""
    seen = []
    make = trainer.make_native_loaders

    def recording(*a, **kw):
        loaders = make(*a, **kw)
        for i, loader in enumerate(loaders):
            nxt = loader.next_batch
            loader.next_batch = lambda nxt=nxt, i=i: (seen.append(i), nxt())[1]
        return loaders

    monkeypatch.setattr(trainer, "make_native_loaders", recording)
    return seen


def _final_state(out):
    return torch.load(out / "final_checkpt" / "model.pt", weights_only=True)


def test_native_training_resumes_bit_for_bit(train_env, spy):
    root, data = train_env
    train_main(_argv(root, data, root / "straight", "discrete.json", "--max_train_steps", "6"))
    assert len(spy) == 6 and set(spy) == {0, 1}  # both domains drawn, one batch a step
    first = list(spy)
    spy.clear()
    train_main(_argv(root, data, root / "resumed", "discrete.json", "--max_train_steps", "6",
                     "--resume_from_checkpoint", str(root / "straight" / "step_3")))
    assert spy == first[3:]  # the resumed run drew the same domains
    a, b = _final_state(root / "straight"), _final_state(root / "resumed")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    losses = [json.loads(l)["train/loss"] for l in open(root / "straight" / "metrics.jsonl")
              if "train/loss" in l]
    assert len(losses) == 6 and np.isfinite(losses).all()


def test_native_training_continuous(train_env, spy):
    root, data = train_env
    out = root / "cont"
    train_main(_argv(root, data, out, "continuous.json", "--model_type", "continuous",
                     "--max_train_steps", "2"))
    assert len(spy) == 2
    lines = [json.loads(l) for l in open(out / "metrics.jsonl")]
    losses = [l["train/loss"] for l in lines if "train/loss" in l]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(l["train/skipped"] == 0.0 for l in lines if "train/loss" in l)


@pytest.mark.parametrize("card,extra", [("drop.json", ()),
                                        ("discrete.json", ("--overfit_first_batch",))])
def test_assembler_serves_what_the_loader_lacks(train_env, spy, card, extra):
    root, data = train_env
    train_main(_argv(root, data, root / f"asm_{card}_{len(extra)}", card,
                     "--max_train_steps", "1", *extra))
    assert spy == []



class _Recorder:
    """Stands in for a loader class of either package: records each
    loader's constructor arguments and the domain of every batch the
    trainer takes, and serves the real loader's batches."""

    def __init__(self, real):
        self.real, self.made, self.drawn = real, [], []

    def __call__(self, path, config, **kw):
        self.made.append((Path(path).name, kw["batch_size"], kw["seed"],
                          kw["action_width"], kw["start_batch"]))
        loader, domain, drawn = self.real(path, config, **kw), len(self.made) - 1, self.drawn

        class Recording:
            def next_batch(self):
                drawn.append(domain)
                return loader.next_batch()

            def close(self):
                loader.close()

        return Recording()


def _loop_only(monkeypatch, start_step, reference: bool) -> _Recorder:
    """The port's trainer, or hma_tpu's with `reference`, with its train and eval steps made no-ops and
    its checkpoint restore standing in for a checkpoint at `start_step`:
    what runs is the loop around the loaders."""
    if reference:
        import jax
        import jax.numpy as jnp

        from hma_tpu.train import trainer as mod

        rec = _Recorder(jax_native_loader.NativeTokenLoader)
        zero = {"loss": jnp.zeros(()), "skipped": jnp.zeros(())}
        make_model = mod.make_model

        def jitted_init(*a, **k):  # one compile, not one an op
            model = make_model(*a, **k)
            return type("Jitted", (), {"init": staticmethod(jax.jit(model.init)),
                                       "__getattr__": lambda self, n: getattr(model, n)})()

        monkeypatch.setattr(mod, "make_model", jitted_init)
        monkeypatch.setattr(jax_native_loader, "NativeTokenLoader", rec)
        monkeypatch.setattr(mod, "make_train_step", lambda *a, **k: lambda s, b, r: (s, zero))
        monkeypatch.setattr(mod, "make_eval_step", lambda *a, **k: lambda p, b, r: zero)
        monkeypatch.setattr(mod, "save_checkpoint", lambda *a, **k: None)
        monkeypatch.setattr(mod, "load_checkpoint",
                            lambda path, state: state._replace(step=jnp.asarray(start_step)))
    else:
        rec = _Recorder(native_loader.NativeTokenLoader)
        zero = {"loss": torch.zeros(()), "skipped": torch.zeros(())}
        real_load = trainer.load_train_state
        monkeypatch.setattr(native_loader, "NativeTokenLoader", rec)
        monkeypatch.setattr(trainer, "make_train_step", lambda *a, **k: lambda b, rng: zero)
        monkeypatch.setattr(trainer, "make_eval_step", lambda *a, **k: lambda b, rng: zero)
        monkeypatch.setattr(trainer, "load_train_state",
                            lambda path, device: (*real_load(path, device)[:2], start_step))
    return rec


STEPS_PER_EPOCH = 10  # train_env's windows at an effective batch of 8


@pytest.mark.parametrize("start_step", [0, 5, 10, 13, 27])
def test_native_loop_matches_jax(train_env, jax_lib, monkeypatch, start_step):
    """The trainer around the loaders against hma_tpu's (tiny card,
    gradient accumulation 2, so an effective batch of 8, and 34 steps, 3.4
    epochs): the loaders are made with hma_tpu's paths, batch sizes,
    seeds (seed + i), action widths and start batches (replayed domain
    draws), and each step draws hma_tpu's domain (one generator an epoch,
    seeded seed + epoch), from a straight run and from resumes inside the
    first epoch, at its end, and inside the second and third."""
    from hma_tpu.train_multi import main as jax_train_main

    root, data = train_env
    out = root / f"loop_{start_step}"
    argv = _argv(root, data, out / "port", "discrete.json", "--max_train_steps", "34",
                 "--gradient_accumulation_steps", "2", "--checkpointing_steps", "1000")
    resume = []
    if start_step:  # the port restores a real checkpoint, its step replaced
        with monkeypatch.context() as mp:
            _loop_only(mp, 0, reference=False)
            train_main(_argv(root, data, out / "ckpt", "discrete.json", "--max_train_steps",
                             "1", "--gradient_accumulation_steps", "2"))
        resume = ["--resume_from_checkpoint", str(out / "ckpt" / "final_checkpt")]
    with monkeypatch.context() as mp:
        port = _loop_only(mp, start_step, reference=False)
        sizes = []
        sampler = trainer.MultiTaskBatchSampler
        mp.setattr(trainer, "MultiTaskBatchSampler",
                   lambda *a, **k: (sizes.append(len(s := sampler(*a, **k))), s)[1])
        train_main(argv + resume)
    # hma_tpu on one device of the test mesh (--dp 1), as the port trains
    jax_argv = [a for a in argv if a not in ("--device", "cpu")] + ["--dp", "1"]
    jax_argv[jax_argv.index(str(out / "port"))] = str(out / "jax")
    with monkeypatch.context() as mp:
        ref = _loop_only(mp, start_step, reference=True)
        jax_train_main(jax_argv + resume)
    assert sizes[0] == STEPS_PER_EPOCH
    assert port.made == ref.made and len(port.made) == 2
    assert [m[1:3] for m in port.made] == [(8, 5), (8, 6)]
    assert sum(m[4] for m in port.made) == start_step
    assert port.drawn == ref.drawn and len(port.drawn) == 34 - start_step
    assert set(port.drawn) == {0, 1}
