"""Structured metrics logging (counterpart of
``lipreading_tpu/train/metrics_log.py``): one JSON object per line in
``<log_dir>/metrics.jsonl``, echoed to stdout. The TensorBoard mirror is
left out."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, echo: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.f = open(self.path, "a")
        self.echo = echo

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.echo:
            vals = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
            print(f"[step {step}] {vals}", flush=True)

    def log_text(self, step: int, tag: str, text: str) -> None:
        self.f.write(json.dumps({"step": step, tag: text}) + "\n")
        self.f.flush()
        if self.echo:
            print(f"[step {step}] {tag}: {text}", flush=True)

    def close(self) -> None:
        self.f.close()
