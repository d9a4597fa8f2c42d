"""robomimic episode generator: HDF5 demos replayed through MuJoCo.

Rebuild of the reference generator (datasets/extern/robomimic.py:36-79)
with its full semantics:

  - three supported envs (lift, square, can), NUM_EPISODES_PER_TASK
    (200) demos each; a flat example index maps to (env, demo);
  - the env is created once per task from the dataset's own env metadata
    (with image observations enabled) and reset once — the reference
    notes this clears a renderer artifact ("green laser bug");
  - per step, the recorded flattened MuJoCo state is restored
    (`sim.set_state_from_flattened` + `sim.forward`), the frame rendered
    offscreen and resized (render_step, robomimic.py:25-30), and the
    step carries the recorded action + concatenated low-dim obs with the
    env name as the language tag.

The reference imports its own `sim.robomimic` wrappers which do not
exist in its tree (a known reference defect, SURVEY.md §2.6); this port
talks to robomimic's public API directly. The state->frame replay is
factored into `render_step`/`replay_demo` so unit tests can synthesize
demos and stub the env. Root from $ROBOMIMIC_ROOT.

The port's copy of hma_tpu/data/extern/robomimic.py: the same episodes from the
same inputs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from hma_tpu_torch.data.encode_openx import get_shard_inds

ROBOMIMIC_ROOT = os.environ.get("ROBOMIMIC_ROOT", "data/robomimic/datasets")
SUPPORTED_ENVS = ["lift", "square", "can"]
NUM_EPISODES_PER_TASK = 200
OBS_KEYS = ["object", "robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos"]
RESOLUTION = (256, 256)


def render_step(env, state: np.ndarray, image_size: int = 256) -> np.ndarray:
    """Restore a flattened MuJoCo state and render one frame
    (reference: robomimic.py:25-30)."""
    import cv2

    sim = env.env.sim if hasattr(env, "env") else env.sim
    sim.set_state_from_flattened(state)
    sim.forward()
    img = env.render(mode="rgb_array", height=image_size, width=image_size,
                     camera_name="agentview")
    if img.shape[0] != image_size or img.shape[1] != image_size:
        img = cv2.resize(img, (image_size, image_size))
    return img


def replay_demo(env, demo_group, image_size: int = 256,
                env_name: str = "") -> dict:
    """One HDF5 demo group -> {"steps": [...]}; frames re-rendered from
    the recorded states, obs concatenated over OBS_KEYS
    (reference: robomimic.py:55-76)."""
    obs = demo_group["obs"]
    states = np.asarray(demo_group["states"])
    actions = np.asarray(demo_group["actions"]).astype(np.float32)
    present = [k for k in OBS_KEYS if k in obs]
    step_obs = np.concatenate([np.asarray(obs[k]) for k in present],
                              axis=-1).astype(np.float32)
    steps = []
    for a, o, s in zip(actions, step_obs, states):
        steps.append({
            "image": np.asarray(render_step(env, s, image_size)),
            "state": o,
            "action": a,
            "language": env_name,
        })
    return {"steps": steps}


def make_env(dataset_path: str):
    """Env from the dataset's own metadata with image obs on
    (reference: robomimic.py:46-51)."""
    import robomimic.utils.env_utils as EnvUtils
    import robomimic.utils.file_utils as FileUtils

    env_meta = FileUtils.get_env_metadata_from_dataset(dataset_path)
    env_meta["use_image_obs"] = True
    env = EnvUtils.create_env_from_metadata(
        env_meta=env_meta, render=False, render_offscreen=True)
    env.reset()  # clears the reference's "green laser" renderer artifact
    return env


def robomimic_dataset_size() -> int:
    return len(SUPPORTED_ENVS) * NUM_EPISODES_PER_TASK


def robomimic_episode_generator(shard_ind: int, num_shards: int,
                                root: str = ROBOMIMIC_ROOT,
                                image_size: int = 256,
                                example_inds: Optional[Iterable[int]] = None):
    import h5py

    if example_inds is None:
        start, end = get_shard_inds(robomimic_dataset_size(), num_shards,
                                    shard_ind)
        example_inds = range(start, end)

    env = None
    curr_env_name = None
    for idx in example_inds:
        env_name = SUPPORTED_ENVS[idx // NUM_EPISODES_PER_TASK]
        dataset = str(Path(root) / env_name / "ph" / "image.hdf5")
        if not os.path.exists(dataset):
            continue
        if curr_env_name != env_name:
            if env is not None:
                env.close()
            env = make_env(dataset)
            curr_env_name = env_name
        with h5py.File(dataset, "r") as f:
            demo = f"demo_{idx % NUM_EPISODES_PER_TASK}"
            if demo not in f["data"]:
                continue
            yield replay_demo(env, f["data"][demo], image_size, env_name)
    if env is not None:
        env.close()
