"""Repeated bank refreshes, as after every training epoch or weight change.

Set-up builds the program and its first bank. The window repeats: load a
changed set of weights (``TreeModel.load_state_dict``: the drawn weights
with the positional embedding replaced by a fresh seeded draw, which moves
every row), re-encode every class prompt (``update_classifier``) and sort
the bank (``sort_bank``). The image tower does no work here.

Checked after the window: the rows of two refreshes, one of the first few
and the last, against the reference under that refresh's weights.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import check, inputs, reference, work
from ..family import bank_rows
from .base import Outcome, RunContext, free_program


def changed_weights(rc: RunContext, sd: Dict[str, torch.Tensor], k: int) -> Dict:
    """The weights of refresh ``k``: ``sd`` with a fresh positional embedding."""
    pos = sd["positional_embedding"]
    g = torch.Generator(device=pos.device).manual_seed(inputs.torch_seed(rc.seed, 51, k))
    out = dict(sd)
    out["positional_embedding"] = torch.randn(pos.shape, generator=g, device=pos.device) \
        * rc.traffic["position_std"]
    return out


def run(rc: RunContext) -> Outcome:
    tr, cfg, dev = rc.traffic, rc.cfg, rc.device
    prog = rc.build(keep_weights=True)
    tm, classes, sd = prog.tm, prog.classes, prog.weights
    N = classes.num_nodes
    check_first = int(inputs.stream(rc.seed, 52).integers(0, tr["check_from_first"]))

    def refresh(k: int):
        with rc.span("refresh.load_weights"):
            tm.load_state_dict(changed_weights(rc, sd, k))
        with rc.span("refresh.update_classifier"):
            bank = tm.update_classifier()
        with rc.span("refresh.sort_bank"):
            return tm.sort_bank(bank)

    with rc.clock.part("bank"):
        for k in range(tr["warmup_refreshes"]):
            refresh(10**6 + k)  # weights no window refresh uses
        rc.sync()

    def window(first: int, seconds: float, traced: bool):
        """Refreshes from ``first`` for ``seconds``: (count, start, end, kept
        sorted banks)."""
        kept, n = {}, 0
        t0 = rc.window_start(traced)
        while time.perf_counter() - t0 < seconds:
            bank_s = refresh(first + n)
            if first + n == check_first:
                kept[first + n] = bank_s
            n += 1
        rc.sync()
        t1 = time.perf_counter()
        rc.window_end(traced)
        kept[first + n - 1] = bank_s
        return n, t0, t1, kept

    n, t0, t1, kept = window(0, rc.seconds, False)
    out = Outcome(attempted=n, failed=0)
    out.e2e["bank_refresh_ms"] = (t1 - t0) / n * 1e3
    lengths = inputs.prompt_lengths(classes.tokens(cfg))
    out.work = {"flops": n * rc.family.text_flops(cfg, lengths), "window_s": t1 - t0}
    if rc.trace:
        nt, *_ = window(n, rc.trace_seconds, True)
        out.work["k1_bound_s"] = nt * work.bound_s(rc.family.text_attention_work(cfg, lengths))
    out.memory_peak = rc.memory_peak()
    out.notes.append(f"# bank-refresh: {n} refreshes in {t1 - t0:.4f} s")
    saved = {"order": np.asarray(tm.depth_order[:N]),
             "banks": {k: b[:N].cpu() for k, b in kept.items()}}
    del kept
    free_program(prog)
    out.checks = judge(rc, classes, saved)
    return out


def judge(rc: RunContext, classes, saved, quant=None) -> Dict[str, float]:
    cfg, dev, fam = rc.cfg, rc.device, rc.family
    reference.set_fp32(dev)
    sd = fam.draw_weights(cfg, rc.weight_seed, dev)
    tokens = torch.as_tensor(classes.tokens(cfg), device=dev).long()
    N = classes.num_nodes
    rows = np.sort(inputs.stream(rc.seed, 53).choice(N, size=min(rc.traffic["check_rows"], N),
                                                     replace=False))
    rows_t = torch.as_tensor(rows, device=dev)
    if quant is None:
        order = saved["order"]
        if not np.array_equal(np.sort(order), np.arange(N)):
            return {"bank_row_err": float("inf")}
        pos_of = np.empty(N, np.int64)
        pos_of[order] = np.arange(N)
    worst = 0.0
    for k, bank_s in saved["banks"].items():
        w = changed_weights(rc, sd, k)
        ref = bank_rows(fam, w, cfg, tokens[rows_t])
        if quant is None:
            prog = bank_s[torch.as_tensor(pos_of[rows])].to(dev).float()
        else:
            prog = bank_rows(fam, w, cfg, tokens[rows_t], quant)
        worst = max(worst, check.row_err(prog, ref))
    return {"bank_row_err": worst}


def control(rc: RunContext, quant) -> Dict[str, float]:
    """The numbers of the control: the reference in ``quant``'s precision in
    the program's place, over the refresh a run keeps from its first few."""
    from ..system import make_classes

    classes = make_classes(rc.cfg, rc.seed)
    first = int(inputs.stream(rc.seed, 52).integers(0, rc.traffic["check_from_first"]))
    return judge(rc, classes, {"banks": {first: None}}, quant)
