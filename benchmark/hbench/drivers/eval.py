"""Zero-shot evaluation as ``driver.run_test`` runs it.

Set-up builds the class bank (``TreeModel.update_classifier``, then
``sort_bank``). The window runs single-class batches of uint8 images, each
copied from a host ring to the card as ``run_test`` copies its loader's
batches, through the two calls that make up ``TreeModel.eval_step_sorted``
(``encode_image``, then ``metrics_sorted``), and accumulates the metrics as
``run_test`` does. Every batch has an unseen class drawn from the seed.

Checked after the window: bank rows and image features against the
reference, and each kept batch's metric sums against the reference's
worked out from that batch's features and the bank.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import check, inputs, reference, work
from ..family import bank_rows, image_features
from .base import Outcome, RunContext, free_program


def run(rc: RunContext) -> Outcome:
    from hgr_tpu_torch.eval.metrics import accumulate, zeros_metrics
    from hgr_tpu_torch.models.clip import encode_image

    tr, cfg, dev = rc.traffic, rc.cfg, rc.device
    prog = rc.build(keep_weights=False)
    tm, classes = prog.tm, prog.classes
    with rc.clock.part("bank"):
        bank_s = tm.sort_bank(tm.update_classifier())
    B, R, res = tr["batch"], tr["ring_batches"], cfg["vision"]["image_resolution"]
    with rc.clock.part("inputs"):
        ring, targets, keep = make_inputs(rc, classes)
        valid_host = np.ones(B, bool)

    def step(i: int, total, timed: bool):
        with rc.span("eval.h2d"):
            images = torch.from_numpy(ring[i % R]).to(dev)
            valid = torch.from_numpy(valid_host).to(dev)
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        with rc.span("eval.image_tower"):
            feats = encode_image(tm.model, images, dtype=tm.dtype)
        if timed:
            ev[1].record()
        with rc.span("eval.head"):
            m = tm.metrics_sorted(bank_s, feats, int(targets[i % len(targets)]), valid)
        if timed:
            ev[2].record()
            events.append(ev)
        return accumulate(total, m), feats, m

    def window(first: int, seconds: float, traced: bool, timed: bool = False):
        """Steps from ``first`` for ``seconds``: (steps, start, end, kept
        outputs, accumulated metrics)."""
        kept, total, n = {}, zeros_metrics(device=dev), 0
        t0 = rc.window_start(traced)
        while time.perf_counter() - t0 < seconds:
            total, feats, m = step(first + n, total, timed)
            if first + n in keep:
                kept[first + n] = (feats, m)
            n += 1
        rc.sync()
        t1 = time.perf_counter()
        rc.window_end(traced)
        if not kept:  # a window shorter than the sample's range: judge its last batch
            kept[first + n - 1] = (feats, m)
        return n, t0, t1, kept, total

    events = []
    with rc.clock.part("first_steps"):
        total = zeros_metrics(device=dev)
        for i in range(tr["warmup_steps"]):
            total, _, _ = step(i, total, False)
        rc.sync()

    # the measured window; with --trace 1 its CUDA events time the two calls
    n, t0, t1, kept, total = window(0, rc.seconds, False, timed=rc.trace)
    out = Outcome(attempted=n, failed=0)
    out.e2e["eval_imgs_per_s"] = n * B / (t1 - t0)
    out.spans = {"eval.image_tower_ms": [e[0].elapsed_time(e[1]) for e in events],
                 "eval.head_ms": [e[1].elapsed_time(e[2]) for e in events]}
    step_flops = B * rc.family.image_flops(cfg) + work.head_flops(cfg, B, classes.num_nodes)
    out.work = {"flops": n * step_flops, "window_s": t1 - t0}
    out.notes.append(f"# eval: {n} batches of {B} in {t1 - t0:.4f} s; accumulated "
                     f"num {float(total.num):.0f}")
    if rc.trace:
        nt, *_ = window(n, rc.trace_seconds, True)
        k1 = rc.family.image_attention_work(cfg, nt * B)
        if k1 is not None:  # K1 runs in the image tower
            out.work["k1_bound_s"] = work.bound_s(k1)
    out.memory_peak = rc.memory_peak()
    saved = {
        "bank_s": bank_s[: classes.num_nodes].cpu(),
        "order": np.asarray(tm.depth_order[: classes.num_nodes]),
        "batches": {i: (f.cpu(), {k: v.cpu().numpy() for k, v in m._asdict().items()})
                    for i, (f, m) in kept.items()},
    }
    del bank_s, kept, total
    free_program(prog)
    out.checks = judge(rc, classes, ring, targets, saved)
    return out


def make_inputs(rc: RunContext, classes):
    """The host ring of images, the batches' targets, and the batches kept
    for the check."""
    tr = rc.traffic
    B, R, res = tr["batch"], tr["ring_batches"], rc.cfg["vision"]["image_resolution"]
    ring = inputs.images(R * B, res, rc.seed, 1, rc.device).reshape(R, B, res, res, 3)
    targets = inputs.stream(rc.seed, 61).choice(classes.unseen, size=4096)
    keep = set(int(i) for i in inputs.stream(rc.seed, 62).choice(
        tr["check_from_first"], size=tr["check_batches"], replace=False))
    return ring, targets, keep


def control(rc: RunContext, quant) -> Dict[str, float]:
    """The numbers of the control: the reference in ``quant``'s precision in
    the program's place, over the batches a run keeps."""
    from ..system import make_classes

    classes = make_classes(rc.cfg, rc.seed)
    ring, targets, keep = make_inputs(rc, classes)
    return judge(rc, classes, ring, targets, {"batches": {i: None for i in keep}}, quant)


def judge(rc: RunContext, classes, ring, targets, saved, quant=None) -> Dict[str, float]:
    """The cell's numbers. With ``quant`` the reference in that precision
    takes the program's place (the control), which reads ``bank_row_err``
    and ``feat_err`` only: its head, the reference's, is exact given its
    features, so ``metric_excess`` would read 0."""
    cfg, dev, tr, fam = rc.cfg, rc.device, rc.traffic, rc.family
    reference.set_fp32(dev)
    sd = fam.draw_weights(cfg, rc.weight_seed, dev)
    tokens = torch.as_tensor(classes.tokens(cfg), device=dev).long()
    N = classes.num_nodes
    rows = np.sort(inputs.stream(rc.seed, 63).choice(N, size=min(tr["check_rows"], N),
                                                     replace=False))
    rows_t = torch.as_tensor(rows, device=dev)
    ref_rows = bank_rows(fam, sd, cfg, tokens[rows_t])
    B, R = tr["batch"], tr["ring_batches"]
    ids = sorted(saved["batches"])
    imgs = torch.as_tensor(np.concatenate([ring[i % R] for i in ids]), device=dev)
    ref_feats = image_features(fam, sd, cfg, imgs)
    if quant is None:
        order = saved["order"]
        if not np.array_equal(np.sort(order), np.arange(N)):
            return {"bank_row_err": float("inf"), "feat_err": float("inf"),
                    "metric_excess": float("inf")}
        bank = torch.empty_like(saved["bank_s"])
        bank[torch.as_tensor(order)] = saved["bank_s"]
        bank = bank.to(dev)
        feats = torch.cat([saved["batches"][i][0] for i in ids]).to(dev)
        prog_rows = bank[rows_t].float()
    else:
        prog_rows = bank_rows(fam, sd, cfg, tokens[rows_t], quant)
        feats = image_features(fam, sd, cfg, imgs, quant)
    out = {"bank_row_err": check.row_err(prog_rows, ref_rows),
           "feat_err": check.frob_err(feats.float(), ref_feats)}
    if quant is None:
        depth = torch.as_tensor(classes.tree.depth, device=dev)
        test = torch.zeros(N, dtype=torch.bool, device=dev)
        test[torch.as_tensor(classes.unseen, device=dev)] = True
        excess = 0.0
        for j, i in enumerate(ids):
            tgt = int(targets[i % len(targets)])
            rng = check.eval_metric_range(feats[j * B:(j + 1) * B], bank, tgt,
                                          classes.tree.path(tgt), depth, test)
            excess = max(excess, check.metric_excess(saved["batches"][i][1], rng))
        out["metric_excess"] = excess
    return out
