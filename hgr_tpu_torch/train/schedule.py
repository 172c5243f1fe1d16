"""LR schedule: linear warmup + cosine decay (port of
``hgr_tpu/train/schedule.py``).

The reference's ``cosine_lr`` closure (``utils.py:82-95``):
``lr = base * (step+1)/warmup`` during warmup, then
``0.5 * (1 + cos(pi * e / es)) * base`` with ``e = step - warmup``. A plain
``step -> lr`` function; the trainer reads it at the count of updates
already applied, which is where optax evaluates its schedule.
"""

from __future__ import annotations

import math


def cosine_lr(base_lr: float, warmup_length: int, total_steps: int):
    def schedule(step: int) -> float:
        if warmup_length > 0 and step < warmup_length:
            return base_lr * (step + 1.0) / warmup_length
        e = step - warmup_length
        es = max(total_steps - warmup_length, 1)
        return 0.5 * (1.0 + math.cos(math.pi * e / es)) * base_lr

    return schedule
