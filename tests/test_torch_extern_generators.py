"""The port's extern readers against hma_tpu's, on the synthetic annotation
fixtures of tests/test_extern_generators.py (Ego4D narrated actions with hand
boxes, EgoExo4D hand poses, EPIC-KITCHENS detections, robomimic demos with a
stub env; frame IO injected in both packages): equal episodes, step for step.
Toyworld episodes are equal byte for byte for both splits and two shards. The
optional packages (cv2, h5py, robomimic, epic_kitchens) are imported only
inside the functions that need them."""

import ast
import pickle
from pathlib import Path

import numpy as np
import pytest

from hma_tpu.data.extern import ego4d as jax_ego4d
from hma_tpu.data.extern import egoexo4d as jax_egoexo4d
from hma_tpu.data.extern import epic_kitchen as jax_epic_kitchen
from hma_tpu.data.extern import robomimic as jax_robomimic
from hma_tpu.data.extern import toyworld as jax_toyworld
from hma_tpu_torch.data.extern import ego4d, egoexo4d, epic_kitchen, robomimic, toyworld
from test_extern_generators import IMG, _epic_frame, _fho_frame, _pose, _StubEnv

ROOT = Path(__file__).resolve().parent.parent
OPTIONAL = {"cv2", "h5py", "robomimic", "epic_kitchens", "tensorflow_datasets"}


def assert_same_episodes(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a["steps"]) == len(b["steps"])
        for sa, sb in zip(a["steps"], b["steps"]):
            assert sa.keys() == sb.keys()
            for k in sa:
                if isinstance(sa[k], str):
                    assert sa[k] == sb[k]
                else:
                    assert sa[k].dtype == sb[k].dtype
                    np.testing.assert_array_equal(sa[k], sb[k])


def _frame_img(n):
    """A frame whose pixels carry its number, so the episodes' images differ."""
    return np.full((256, 256, 3), n % 251, np.uint8)


def test_ego4d_matches_jax(tmp_path, monkeypatch):
    for mod in (ego4d, jax_ego4d):
        monkeypatch.setattr(mod, "parse_video_frame", lambda p, n: _frame_img(n))
    (tmp_path / "vid0.mp4").write_bytes(b"")
    nframes = ego4d.MIN_STEPS + 4
    frames = [_fho_frame(i + 1, 10 + i, 20 + 2 * i, 100, 120 - i) for i in range(nframes)]
    frames[7]["boxes"] = frames[7]["boxes"][:2]  # too few boxes: the pair is skipped
    per = nframes // 4
    actions = [{"is_invalid_annotation": False, "is_rejected": False, "stage": "done",
                "frames": frames[i * per:(i + 1) * per]} for i in range(4)]
    actions += [{"is_invalid_annotation": True, "is_rejected": False, "stage": "done",
                 "frames": frames},
                {"is_invalid_annotation": False, "is_rejected": False, "stage": None,
                 "frames": frames},
                {"is_invalid_annotation": False, "is_rejected": False, "stage": "done",
                 "frames": frames}]
    labels = {"videos": [{"video_uid": "vid0",
                          "annotated_intervals": [{"narrated_actions": actions}]},
                         {"video_uid": "missing", "annotated_intervals": []}]}
    got = list(ego4d.iter_episodes(labels, str(tmp_path)))
    assert len(got) == 1 and len(got[0]["steps"]) >= ego4d.MIN_STEPS
    assert_same_episodes(got, jax_ego4d.iter_episodes(labels, str(tmp_path)))
    assert ego4d.chunk_actions_and_concatenate(actions) == \
        jax_ego4d.chunk_actions_and_concatenate(actions)
    curr, nxt = frames[0]["boxes"], frames[1]["boxes"]
    for a, b in zip(ego4d.compute_state_and_actions(IMG, curr, nxt),
                    jax_ego4d.compute_state_and_actions(IMG, curr, nxt)):
        np.testing.assert_array_equal(a, b)
    assert ego4d.compute_state_and_actions(IMG, curr[:1], nxt) is None
    with pytest.raises(FileNotFoundError, match="EGO4D_ROOT"):
        next(ego4d.ego4d_episode_generator(0, 1, root=str(tmp_path)))


def test_egoexo4d_matches_jax(tmp_path):
    n = 30
    frames = [_frame_img(i) for i in range(n)]
    detections = {str(i): _pose(64 + i, 64 - i, 192, 128 + i) for i in range(n)}
    del detections["12"]
    detections["22"] = [{"annotation2D": {"cam01": {}}}]  # wrists missing: the chunk ends
    for min_clip in (4, 8, 20):
        got = list(egoexo4d.iter_take_episodes(frames, detections, min_clip=min_clip))
        assert_same_episodes(got, jax_egoexo4d.iter_take_episodes(frames, detections,
                                                                  min_clip=min_clip))
    assert len(list(egoexo4d.iter_take_episodes(frames, detections, min_clip=8))) == 2
    with pytest.raises(FileNotFoundError, match="EGOEXO4D_ROOT"):
        next(egoexo4d.egoexo4d_episode_generator(0, 1, root=str(tmp_path)))


def test_epic_kitchen_matches_jax(tmp_path, monkeypatch):
    for mod in (epic_kitchen, jax_epic_kitchen):
        monkeypatch.setattr(mod, "read_frame", lambda d, i: _frame_img(i))
    det = [_epic_frame((0.2, 0.3), (0.6, 0.7)),
           _epic_frame((0.25, 0.35), (0.55, 0.65), flip=True),
           {"hands": [{"side": "left", "center": (0.0, 0.0)}]},
           _epic_frame((0.3, 0.4), (0.5, 0.6)),
           _epic_frame((0.35, 0.45), (0.45, 0.5), flip=True),
           _epic_frame((0.4, 0.5), (0.4, 0.4))]
    got = epic_kitchen.iter_video_episode("unused", det)
    assert len(got["steps"]) == 2
    assert_same_episodes([got], [jax_epic_kitchen.iter_video_episode("unused", det)])
    path = tmp_path / "det.pkl"
    path.write_bytes(pickle.dumps(det))
    assert epic_kitchen.load_detections(str(path)) == jax_epic_kitchen.load_detections(str(path))
    with pytest.raises(FileNotFoundError, match="EPIC_KITCHEN_ROOT"):
        next(epic_kitchen.epic_kitchen_episode_generator(0, 1, root=str(tmp_path / "no")))


def test_robomimic_matches_jax():
    T = 6
    rng = np.random.default_rng(3)
    demo = {"obs": {"object": rng.normal(size=(T, 10)).astype(np.float32),
                    "robot0_eef_pos": rng.normal(size=(T, 3)).astype(np.float32),
                    "robot0_gripper_qpos": rng.normal(size=(T, 2)).astype(np.float32)},
            "states": np.arange(T)[:, None].repeat(4, 1).astype(np.float64) * 7,
            "actions": rng.normal(size=(T, 7))}
    got = robomimic.replay_demo(_StubEnv(), demo, image_size=256, env_name="can")
    want = jax_robomimic.replay_demo(_StubEnv(), demo, image_size=256, env_name="can")
    assert got["steps"][0]["state"].shape == (15,)
    assert_same_episodes([got], [want])
    assert robomimic.robomimic_dataset_size() == jax_robomimic.robomimic_dataset_size()


@pytest.mark.parametrize("split,num_shards,shards", [("train", 60, (0, 59)),
                                                      ("val", 24, (3, 23))])
def test_toyworld_matches_jax_byte_for_byte(split, num_shards, shards):
    for shard in shards:
        got = list(toyworld.toyworld_episode_generator(shard, num_shards, split=split))
        want = list(jax_toyworld.toyworld_episode_generator(shard, num_shards, split=split))
        assert len(got) == len(want) == toyworld.NUM_EPISODES[split] // num_shards
        assert_same_episodes(got, want)
        for a, b in zip(got, want):
            for sa, sb in zip(a["steps"], b["steps"]):
                assert sa["image"].tobytes() == sb["image"].tobytes()
                assert sa["action"].tobytes() == sb["action"].tobytes()


def test_optional_packages_are_imported_lazily():
    """No module of data/extern (nor encode_openx) imports an optional
    package at its top level: the card's machine has none of them."""
    files = sorted((ROOT / "hma_tpu_torch" / "data" / "extern").glob("*.py"))
    files.append(ROOT / "hma_tpu_torch" / "data" / "encode_openx.py")
    for f in files:
        top = set()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.add(node.module.split(".")[0])
        assert not top & OPTIONAL, (f, top & OPTIONAL)
    assert {f.stem for f in files} >= {"toyworld", "ego4d", "egoexo4d", "epic_kitchen",
                                       "robomimic"}
