"""Text logging (counterpart of `vspbfr_tpu/utils/logging.py`; the
reference's `Logger/Logger.py`): append-only "[iter] [k]:v" lines."""

from __future__ import annotations

import os
import time
from typing import Mapping


class Logger:
    """Append-only metrics log, one file per stream."""

    def __init__(self, path: str, name: str = "train"):
        os.makedirs(path, exist_ok=True)
        self.file = os.path.join(path, f"{name}.log")

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        parts = " ".join(f"[{k}]:{float(v):.6g}" for k, v in metrics.items())
        with open(self.file, "a") as f:
            f.write(f"[{step}] {parts} [t]:{time.time():.0f}\n")
