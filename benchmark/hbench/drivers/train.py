"""OM fine-tuning as ``driver.run_train`` feeds its step.

Set-up builds one train state (the program's ``init_train_state`` over its
model and per-depth weight, ``make_optimizer``, ``make_train_step``), the
program's ``NegativeSampler`` and ``ScheduleBuilder``, and a background
thread (the program's ``Prefetcher``) that builds each step's pair
schedule on the host while the card runs the step before, as
``run_train`` does. The first three steps run in set-up, through the same
call and feed, on rows that all differ; the reference follows them. The
window goes on training the same state. Each step's batch is copied from a
host ring, its halves lighter and darker; its target is a seen class, at depths in the proportions of the
seen classes' levels, the same mix of depths for every seed.

Checked after the window, against the reference's: the first step's
clipped gradient as AdamW holds it (its first moment over 1 - beta1), and
the change of the weights after the three steps, by its norms and its
signs; the three steps' losses are read and printed.
"""

from __future__ import annotations

import time
from types import ModuleType
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, reference, reference_train, work
from .base import Outcome, RunContext, free_program

CHECKED_STEPS = 3


def targets_of(rc: RunContext, classes) -> np.ndarray:
    """Step targets: blocks of ``depth_block`` depths, the quantiles of the
    seen classes' depths, each block in a seeded order, and a seen class of
    that depth drawn from the seed."""
    tree, n = classes.tree, rc.traffic["depth_block"]
    seen = np.setdiff1d(np.arange(classes.num_nodes), classes.unseen)
    depths = np.sort(tree.depth[seen])
    block = depths[((np.arange(n) + 0.5) / n * len(depths)).astype(int)]
    rng = inputs.stream(rc.seed, 81)
    by_depth = {d: seen[tree.depth[seen] == d] for d in np.unique(block)}
    out = []
    for _ in range(rc.traffic["max_blocks"]):
        for d in rng.permutation(block):
            out.append(int(rng.choice(by_depth[d])))
    return np.asarray(out)


def ring_of(rc: RunContext) -> np.ndarray:
    """The host ring of batches [R, B, H, W, 3]: the two halves of each
    batch ``half_shift`` lighter and darker, so that their gradients
    differ and a step that leaves half of its batch out reads apart from
    the reference (the rows of one target's batch otherwise share most of
    their gradient)."""
    tr, res = rc.traffic, rc.cfg["vision"]["image_resolution"]
    R, B = tr["ring_batches"], tr["batch"]
    return inputs.images(R * B, res, rc.seed, 3, rc.device, shift=tr["half_shift"],
                         group=B).reshape(R, B, res, res, 3)


OPTIMIZER = ("lr", "wd", "w_lr", "grad_clip", "warmup_length")


def hyper(rc: RunContext) -> Dict:
    """The optimizer's settings of the mix, and the schedule's length."""
    return {k: rc.traffic[k] for k in OPTIMIZER + ("schedule_steps",)}


def run(rc: RunContext) -> Outcome:
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.data import Prefetcher
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, init_train_state,
                                     make_optimizer, make_train_step, sched_to_device)

    tr, cfg, dev = rc.traffic, rc.cfg, rc.device
    prog = rc.build(keep_weights=True)
    tm, classes, sd0 = prog.tm, prog.classes, prog.weights
    B, R = tr["batch"], tr["ring_batches"]
    with rc.clock.part("train_state"):
        config = Config(arch=cfg["arch"], dtype=cfg["dtype"], batch_size=B,
                        num_compare=tr["num_compare"], remat=tr["remat"],
                        out_ratio=tr["out_ratio"], in_ratio=tr["in_ratio"], k=tr["k"],
                        weights="adaptive", weighting="both", training_method="OM",
                        sample_strategy="topk", **{k: tr[k] for k in OPTIMIZER})
        tx = make_optimizer(config, tr["schedule_steps"])
        state = init_train_state(tm.model, tm.layer_weight, tx)
        step_fn = make_train_step(config, tx, dtype=tm.dtype)
        sampler = NegativeSampler(tm.hier, tm.train_index, config.num_compare, k=config.k,
                                  seed=rc.seed, topk_window="below")
        builder = ScheduleBuilder(tm.hier, sampler, config.out_ratio, config.in_ratio,
                                  config.num_compare, method="OM", strategy="topk")
        node_tokens = torch.as_tensor(tm.node_tokens, device=dev).long()
    with rc.clock.part("inputs"):
        ring = ring_of(rc)
        targets = targets_of(rc, classes)
    build_ms: List[float] = []

    def produce():
        for s, t in enumerate(targets):
            t0 = time.perf_counter()
            sched = builder.build(int(t))
            build_ms.append((time.perf_counter() - t0) * 1e3)
            yield s, ring[s % R], sched

    steps = Prefetcher(produce, depth=2)
    it = iter(steps)

    def step(images, sched):
        with rc.span("train.h2d"):
            x = torch.from_numpy(images).to(dev)
            sd = sched_to_device(sched, dev)
        with rc.span("train.step"):
            return step_fn(state, x, node_tokens, sd)

    try:
        with rc.clock.part("first_steps"):
            losses, scheds = [], []
            names = list(tm.model.state_dict(keep_vars=True))
            for s in range(CHECKED_STEPS):
                _, images, sched = next(it)
                scheds.append(sched)
                _, loss = step(images, sched)
                losses.append(float(loss))
                if s == 0:
                    grads = first_gradients(tm.model, state.opt_state.adamw)
            params = tm.model.state_dict()
            change = {k: (params[k].float() - sd0[k]).cpu() for k in names}
            rc.sync()
        def window(seconds: float, traced: bool):
            """Steps for ``seconds``: (steps, start, end, schedules, build
            times, last loss)."""
            scheds, built = [], len(build_ms)
            t0 = rc.window_start(traced)
            while time.perf_counter() - t0 < seconds:
                _, images, sched = next(it)
                scheds.append(sched)
                _, loss = step(images, sched)
            rc.sync()
            t1 = time.perf_counter()
            rc.window_end(traced)
            return len(scheds), t0, t1, scheds, build_ms[built: built + len(scheds)], loss

        n, t0, t1, window_scheds, window_build, loss = window(rc.seconds, False)
        if rc.trace:
            window(rc.trace_seconds, True)
    finally:
        steps.stop()
    out = Outcome(attempted=n, failed=0)
    out.e2e["train_imgs_per_s"] = n * B / (t1 - t0)
    out.memory_peak = rc.memory_peak()
    out.spans = {"train.host_schedule_ms": window_build}
    lengths = inputs.prompt_lengths(classes.tokens(cfg))
    prompts = [np.unique(sc.compare[sc.compare_valid]) for sc in window_scheds]
    out.work = {"flops": sum(train_flops(rc.family, cfg, B, lengths[p]) for p in prompts),
                "window_s": t1 - t0}
    prompts = [len(p) for p in prompts]
    out.notes.append(f"# train: {n} steps of {B} in {t1 - t0:.4f} s; last loss "
                     f"{float(loss):.6f}; prompts a step {min(prompts)}-{max(prompts)}, mean "
                     f"{np.mean(prompts):.1f}; host schedule ms mean "
                     f"{np.mean(window_build) if window_build else float('nan'):.3f}")
    saved = {"losses": losses, "grads": grads, "change": change,
             "sets": [sets_of(sc) for sc in scheds]}
    del state, step_fn, tx
    free_program(prog)
    out.checks = judge(rc, classes, ring, targets, saved)
    # read, not compared: neither the control nor a fault reads three times
    # the sound runs' largest (PERF.md)
    out.notes.append(f"# train: loss_gap {out.checks.pop('loss_gap')!r} (not compared)")
    return out


def first_gradients(model, adamw) -> Dict[str, float]:
    """Per leaf, the norm of the clipped gradient of the first step as AdamW
    holds it: its first moment over ``1 - beta1``."""
    beta1 = adamw.param_groups[0]["betas"][0]
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        st = adamw.state.get(t, {})
        m = st.get("exp_avg")
        out[name] = float(m.double().norm() / (1 - beta1)) if m is not None else 0.0
    return out


def sets_of(sched) -> Dict[str, np.ndarray]:
    """The parts of a pair schedule the reference checks and reads."""
    return {"compare": np.asarray(sched.compare), "valid": np.asarray(sched.compare_valid),
            "label": np.asarray(sched.label), "pair_valid": np.asarray(sched.pair_valid)}


def train_flops(fam: ModuleType, cfg: Dict, batch: int, lengths) -> float:
    """Model operations of one step by the family's counts: the image tower
    over the batch, the text tower over the step's distinct prompts at
    their own lengths, and the logits of every image against them; forward
    and backward, three times the forward (remat's recompute not counted)."""
    fwd = batch * fam.image_flops(cfg) + fam.text_flops(cfg, lengths)
    return 3.0 * (fwd + work.head_flops(cfg, batch, len(lengths)))


def judge(rc: RunContext, classes, ring, targets, saved, quant=None) -> Dict[str, float]:
    """Loss, first gradient and change of the three checked steps against
    the reference's; with ``quant`` the reference in that precision (and its
    own draw of negatives) stands in the program's place."""
    cfg, dev, tr, fam = rc.cfg, rc.device, rc.traffic, rc.family
    reference.set_fp32(dev)
    tree = classes.tree
    levels = reference_train.levels_of(tree)
    ratios = (tr["out_ratio"], tr["in_ratio"])
    tokens = torch.as_tensor(classes.tokens(cfg), device=dev).long()
    lw0 = torch.tensor(1.0 / np.bincount(tree.depth), dtype=torch.float32, device=dev)
    R = tr["ring_batches"]

    def follow(q, sets_for):
        sd = fam.draw_weights(cfg, rc.weight_seed, dev)
        trainer = reference_train.Trainer(sd, lw0, hyper(rc))
        losses, grads = [], None
        for s in range(CHECKED_STEPS):
            t = int(targets[s])
            imgs = torch.as_tensor(ring[s % R], device=dev)
            losses.append(float(reference_train.om_loss(
                fam, trainer.params, trainer.lw, cfg, imgs, tokens, tree, t, sets_for(s, t),
                ratios, q)))
            g = trainer.update()
            if s == 0:
                grads = g
        change = {k: (p.detach() - sd[k]) for k, p in trainer.params.items()}
        return losses, grads, change

    if quant is None:
        try:
            sets = [reference_train.check_schedule(
                tree, levels, int(targets[s]), **saved["sets"][s], ratios=ratios,
                num_compare=tr["num_compare"]) for s in range(CHECKED_STEPS)]
        except ValueError as e:
            print(f"# schedule: {e}", flush=True)
            return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                    "change_gap": float("inf"), "sign_gap": float("inf")}
        ref = follow(None, lambda s, t: sets[s])
        prog = saved["losses"], saved["grads"], saved["change"]
    else:
        rng = inputs.stream(rc.seed, 82)
        drawn = [reference_train.draw_compare_sets(tree, levels, int(targets[s]), ratios,
                                                   tr["num_compare"], rng)
                 for s in range(CHECKED_STEPS)]
        pl, pg, pc = follow(quant, lambda s, t: drawn[s])
        prog = pl, {k: float(x.double().norm()) for k, x in pg.items()}, pc
        ref = follow(None, lambda s, t: drawn[s])
    return train_gaps(prog, ref)


def train_gaps(prog, ref) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a checked step's loss.
    ``grad_gap``: the median leaf's relative gap between the norms of the
    first clipped gradient (the worst leaf's is a stem BatchNorm leaf of 32
    or 64 elements whose bf16 rounding swings from seed to seed, PERF.md).
    ``change_gap``: the worst leaf's gap between the norms of the weights'
    change after the checked steps, over the reference's norm of that leaf
    or of the median leaf, whichever is larger. ``sign_gap``: the share of
    elements whose change has the other sign than the reference's (Adam's
    first steps move each by about the learning rate, in its gradient's
    direction), over the elements whose first reference gradient is at
    least its leaf's root mean square: bf16 rounding flips the signs of
    smaller ones, a changed gradient those too. Both read only the
    elements whose first reference gradient is at least a thousandth of
    the median leaf's root mean square: the others, such as a key's bias
    under the softmax, move under Adam by round-off alone."""
    (pl, pg, pc), (rl, rg, rc_) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    rn = {k: float(x.double().norm()) for k, x in rg.items()}
    grad_gap = float(np.median([abs(pg[k] - rn[k]) / rn[k] for k in rn if rn[k] > 0]))
    thr = 1e-3 * float(np.median([rn[k] / max(x.numel(), 1) ** 0.5 for k, x in rg.items()]))
    a, b = {}, {}
    flips = total = 0
    for k, g in rg.items():
        mask = g.abs() >= thr
        if mask.any():
            dp, dr = pc[k].to(g.device)[mask], rc_[k][mask]
            b[k] = float(dr.double().norm())
            a[k] = float(dp.double().norm())
            major = g[mask].abs() >= g.double().pow(2).mean().sqrt().float()
            flips += int(((torch.sign(dp) != torch.sign(dr)) & major).sum())
            total += int(major.sum())
    med_c = float(np.median(list(b.values())))
    change_gap = max(abs(a[k] - b[k]) / max(b[k], med_c) for k in b)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "sign_gap": flips / max(total, 1)}


def control(rc: RunContext, quant) -> Dict[str, float]:
    """The control: the reference at ``quant`` in the program's place over
    the three checked steps, on its own draw of negatives."""
    from ..system import make_classes

    classes = make_classes(rc.cfg, rc.seed)
    return judge(rc, classes, ring_of(rc), targets_of(rc, classes), {}, quant)
