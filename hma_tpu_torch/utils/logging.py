"""Experiment metric logging to `metrics.jsonl` (own copy of
hma_tpu/utils/logging.py without its optional wandb sink).

Every record is one JSON line: the metrics, `_step` when given, and the
wall-clock `_ts`; the run's config is the first line.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional


class MetricLogger:
    def __init__(self, output_dir: str, config: Optional[dict] = None):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.output_dir / "metrics.jsonl", "a")
        if config:
            self._write({"_config": _jsonable(config), "_ts": time.time()})

    def _write(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {k: _jsonable(v) for k, v in metrics.items()}
        if step is not None:
            rec["_step"] = int(step)
        rec["_ts"] = time.time()
        self._write(rec)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(v: Any):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    try:
        json.dumps(v)
        return v
    except TypeError:
        if hasattr(v, "tolist"):  # numpy / torch; a 0-d one gives a number
            return v.tolist()
        return str(v)
