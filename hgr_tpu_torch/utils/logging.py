"""Metric formatting + run logs (the port's copy of
``hgr_tpu/utils/logging.py``).

Reproduces the reference's report format (``count_acc`` at
``utils.py:135-146`` plus the ratio lines at ``main.py:193-216``) and its
append-only run log — with the filename typo fixed (the reference writes
``arugements.log``, ``main.py:99``; SURVEY appendix item 8) — and adds a
machine-readable JSONL stream alongside.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Mapping, Sequence

from ..eval.metrics import TOPK

LOG_NAME = "arguments.log"


def format_report(summary: Mapping[str, float], topk: Sequence[int] = TOPK) -> str:
    """The reference's one-line report: ``Top@k(%):.. , ... hit_ratio(%):..``."""
    parts = []
    for i, k in enumerate(topk):
        sep = "." if i == len(topk) - 1 else ","
        parts.append(f"Top@{k}(%):{summary[f'hit@{k}']:.2f}{sep}")
    line = " ".join(parts)
    line += f" hit_ratio(%):{summary['tor']:.2f}"
    line += f" path_ratio(%):{summary['path_ratio']:.2f}"
    line += f" point_ratio(%):{summary['point_ratio']:.2f}"
    return line


class RunLogger:
    """Append-only text + JSONL logger under the run's save path."""

    def __init__(self, save_path: str, echo: bool = True):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self.text_path = os.path.join(save_path, LOG_NAME)
        self.jsonl_path = os.path.join(save_path, "metrics.jsonl")
        self.echo = echo

    def log_text(self, line: str) -> None:
        if self.echo:
            print(line, flush=True)
        with open(self.text_path, "a") as f:
            f.write(line + "\n")

    def log_config(self, config: Any) -> None:
        """Dump all config fields at train start (reference main.py:232-237)."""
        d = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        with open(self.text_path, "a") as f:
            for k, v in d.items():
                f.write(f"{k} : {v}\n")
        self.log_jsonl({"event": "config", **{k: str(v) for k, v in d.items()}})

    def log_jsonl(self, record: Dict[str, Any]) -> None:
        record = {"ts": time.time(), **record}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_train(self, epoch: int, step: int, num_batches: int, loss: float) -> None:
        self.log_text(f"loss: {loss:.2f}, {step}/{num_batches}")
        self.log_jsonl(
            {"event": "train", "epoch": epoch, "step": step, "loss": loss}
        )

    def log_eval(self, summary: Mapping[str, float], tag: str = "") -> None:
        self.log_text(("" if not tag else f"[{tag}] ") + format_report(summary))
        self.log_jsonl({"event": "eval", "tag": tag, **dict(summary)})

    def log_global_summary(self, weights: str, out_ratio: float, in_ratio: float,
                           summary: Mapping[str, float]) -> None:
        """The reference's per-weighting global file ``{weights}.txt``
        (``main.py:217-222``)."""
        path = f"{weights}.txt"
        with open(path, "a") as f:
            f.write(f"{weights},{out_ratio},{in_ratio}:\n")
            f.write(format_report(summary) + "\n")


class SilentLogger(RunLogger):
    """The logger of a rank that writes nothing: every rank but 0 of a
    multi-process run."""

    def __init__(self, save_path: str):
        self.save_path = save_path
        self.text_path = self.jsonl_path = os.devnull
        self.echo = False

    def log_global_summary(self, *args, **kwargs) -> None:
        pass
