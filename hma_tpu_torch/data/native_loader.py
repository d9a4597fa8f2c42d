"""ctypes binding of the C++ data loader (counterpart of
hma_tpu/data/native_loader.py; source: hma_tpu_torch/cpp/hma_loader.cpp).

Builds the library at first use with

    g++ -O3 -std=c++17 -shared -fPIC -o libhma_loader-<hash>.so hma_loader.cpp -lpthread

into `<repo>/build/hma_tpu_torch/`, the file named by a hash of the source
and the flags (as `ops/_build.py` names the CUDA libraries), and exposes
`NativeTokenLoader` and `NativeFeatureLoader`: iterators of ready numpy
batches whose memmap reads and MaskGIT collation run in C++ prefetch
threads. Without a compiler it raises: `--use_native_loader` has no quiet
way back to the Python assembler.

Batch i is a pure function of (seed, i) and delivery is in index order
regardless of thread count (cpp OrderedPrefetcher), so runs are
reproducible and `start_batch=k` resumes exactly at batch k of a fresh
run's sequence.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from hma_tpu_torch.config import GenieConfig
from hma_tpu_torch.data.datasets import SVD_SCALE
from hma_tpu_torch.data.freq_table import DATA_FREQ_TABLE

SOURCE = Path(__file__).resolve().parent.parent / "cpp" / "hma_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hma_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LIB = None


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libhma_loader-{tag}.so"


def _build_library() -> Path:
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader is built from "
                           f"{SOURCE} at first use; leave out --use_native_loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent processes never
    # load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load_library():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _build_library()
    lib = ctypes.CDLL(str(so))
    lib.hma_loader_create.restype = ctypes.c_void_p
    lib.hma_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64]
    lib.hma_loader_next.restype = ctypes.c_int
    lib.hma_loader_next.argtypes = [ctypes.c_void_p] + [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_void_p]
    lib.hma_loader_num_windows.restype = ctypes.c_int64
    lib.hma_loader_num_windows.argtypes = [ctypes.c_void_p]
    lib.hma_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.hma_floader_create.restype = ctypes.c_void_p
    lib.hma_floader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64]
    lib.hma_floader_next.restype = ctypes.c_int
    lib.hma_floader_next.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_void_p]
    lib.hma_floader_num_windows.restype = ctypes.c_int64
    lib.hma_floader_num_windows.argtypes = [ctypes.c_void_p]
    lib.hma_floader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class NativeTokenLoader:
    """Prefetching discrete-token batch loader over one dataset directory.

    Yields dicts matching the Python BatchAssembler contract:
    input_ids/labels (B, T, S) int32 [+ action_ids (B, T, width) f32].
    """

    def __init__(self, data_dir: str, config: GenieConfig, batch_size: int,
                 *, stride: Optional[int] = None, seed: int = 0,
                 num_threads: int = 2, queue_depth: int = 4,
                 action_width: Optional[int] = None, start_batch: int = 0):
        lib = _load_library()
        data_dir = Path(data_dir)
        meta = json.loads((data_dir / "metadata.json").read_text())
        self.meta = meta
        self.config = config
        self.B = batch_size
        self.T = config.T
        self.h, self.w = meta["h"], meta["w"]
        self.S = self.h * self.w
        if stride is None:
            stride = max(DATA_FREQ_TABLE.get(meta.get("name", ""), 1) // 2, 1)
        self.stride = stride
        action_dim = meta.get("action_dim", 0)
        actions_path = data_dir / "actions" / "actions.bin"
        has_actions = actions_path.exists() and config.use_actions
        self.action_width = (action_width if action_width is not None
                             else action_dim * stride) if has_actions else 0

        self._handle = lib.hma_loader_create(
            str(data_dir / "video.bin").encode(),
            str(data_dir / "segment_ids.bin").encode(),
            str(actions_path).encode() if has_actions else b"",
            meta["num_images"], self.h, self.w, self.T, stride, batch_size,
            action_dim if has_actions else 0, self.action_width,
            config.image_vocab_size, config.factored_vocab_size,
            config.num_factored_vocabs, config.max_corrupt_rate,
            config.non_mlm_ratio, config.num_prompt_frames,
            config.dataloader_mask_ratio_min,
            int(config.dataloader_apply_corruption),
            int(config.dataloader_apply_mask), seed, num_threads, queue_depth,
            start_batch)
        if not self._handle:
            raise RuntimeError(f"failed to open dataset at {data_dir}")
        self._lib = lib

    def num_windows(self) -> int:
        return int(self._lib.hma_loader_num_windows(self._handle))

    def next_batch(self) -> dict:
        inp = np.empty((self.B, self.T, self.S), np.int32)
        lab = np.empty((self.B, self.T, self.S), np.int32)
        act = (np.empty((self.B, self.T, self.action_width), np.float32)
               if self.action_width else None)
        ok = self._lib.hma_loader_next(
            self._handle, inp, lab,
            act.ctypes.data_as(ctypes.c_void_p) if act is not None else None)
        if not ok:
            raise StopIteration
        out = {"input_ids": inp, "labels": lab}
        if act is not None:
            out["action_ids"] = act
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.hma_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeFeatureLoader:
    """Prefetching continuous-latent batch loader (STMAR training feed).

    Yields dicts matching maskgit_collate_feature's contract:
    input_ids/labels (B, T, h, w, C) f32 x SVD_SCALE +
    masked_tokens_indicator (B, T, h, w) int32
    [+ action_ids (B, T, width) f32]. fp16 decode, windowing, and the
    cosine mask schedule all run in C++ prefetch threads
    (reference collator: hma/data.py:103-157; dataset: hma/data.py:298-435).
    """

    def __init__(self, data_dir: str, config, batch_size: int, *,
                 stride: Optional[int] = None, seed: int = 0,
                 num_threads: int = 2, queue_depth: int = 4,
                 action_width: Optional[int] = None, start_batch: int = 0):
        lib = _load_library()
        data_dir = Path(data_dir)
        meta = json.loads((data_dir / "metadata.json").read_text())
        self.meta = meta
        self.config = config
        self.B = batch_size
        self.T = config.T
        self.h, self.w = meta["h"], meta["w"]
        self.C = meta.get("latent_channels", 4)
        if stride is None:
            stride = max(DATA_FREQ_TABLE.get(meta.get("name", ""), 1) // 2, 1)
        self.stride = stride
        action_dim = meta.get("action_dim", 0)
        actions_path = data_dir / "actions" / "actions.bin"
        has_actions = actions_path.exists() and config.use_actions
        self.action_width = (action_width if action_width is not None
                             else action_dim * stride) if has_actions else 0

        self._handle = lib.hma_floader_create(
            str(data_dir / "video.bin").encode(),
            str(data_dir / "segment_ids.bin").encode(),
            str(actions_path).encode() if has_actions else b"",
            meta["num_images"], self.C, self.h, self.w, self.T, stride,
            batch_size, action_dim if has_actions else 0, self.action_width,
            config.non_mlm_ratio, config.num_prompt_frames,
            config.dataloader_mask_ratio_min,
            int(config.dataloader_apply_mask), float(SVD_SCALE),
            seed, num_threads, queue_depth, start_batch)
        if not self._handle:
            raise RuntimeError(f"failed to open dataset at {data_dir}")
        self._lib = lib

    def num_windows(self) -> int:
        return int(self._lib.hma_floader_num_windows(self._handle))

    def next_batch(self) -> dict:
        lat = np.empty((self.B, self.T, self.h, self.w, self.C), np.float32)
        lab = np.empty((self.B, self.T, self.h, self.w, self.C), np.float32)
        mask = np.empty((self.B, self.T, self.h, self.w), np.int32)
        act = (np.empty((self.B, self.T, self.action_width), np.float32)
               if self.action_width else None)
        ok = self._lib.hma_floader_next(
            self._handle, lat, lab, mask,
            act.ctypes.data_as(ctypes.c_void_p) if act is not None else None)
        if not ok:
            raise StopIteration
        out = {"input_ids": lat, "labels": lab,
               "masked_tokens_indicator": mask}
        if act is not None:
            out["action_ids"] = act
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.hma_floader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
