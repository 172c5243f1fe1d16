#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hgr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel under ``hgr_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print the build time;
3. kernels against their plain versions on the card, at the main path's
   shapes and the edges of K1's contract (``KERNEL_CASES``), each with q/k/v
   as strided views of the packed projection and as contiguous tensors,
   with the stated tolerances; times of kernel, plain version and the
   library yardstick (``scaled_dot_product_attention``, never called by the
   port), and each case's bound;
4. zero-shot eval at full width: RN50, the 18,278-class bank padded to
   18,432, ``run_test`` over 8 batches of 512 synthetic images; K1's launch
   count over that run must be 12 layers x 36 chunks = 432;
5. the class bank rebuilt with the plain attention, held to the kernel's;
6. the card against the port's CPU path (the one the CPU tests hold to the
   JAX package) on a small input, in float32;
7. ViT-B/32 eval at full width against the same bank: ``run_test`` over 2
   batches of 512, where K1 also runs the image tower (T = 50, no mask, 12
   layers), so 432 + 12 x 2 = 456 launches; one batch's features through K1
   held to the plain attention's;
8. OM training at full width: ``driver.run_train`` on RN50 in bf16 with
   remat, batch 256, 256 negatives, 4 episodes, then ``run_test`` over 2
   batches; every loss finite, the CLIP weights and ``layer_weight`` moved,
   no K1 launch inside a train step (autograd runs the plain attention)
   and 432 in the test after it, and ``clip_0`` restores into a fresh
   train state; prints the steps' median time, images/s, the prompts
   encoded per step and peak memory;
9. one OM train step in float32 on the card against the port's CPU path
   (small TEST-ViT config, the same weights and schedule): the loss and the
   updated weights agree within the CPU tests' tolerances;
10. K1's guard: a CUDA call that autograd would record raises.

The second-to-last lines are the kernel table (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # fp32 outside the tensor cores
LEVEL_SIZES = [10, 800, 4000, 5000, 4000, 2500, 1000, 500, 250, 120, 60, 30, 8]
# phase 3's (shape, causal settings): the bank build's T = 32, CLIP's full
# context 77 and a short prompt 20; ViT-B/32's 50 and ViT-B/16's 197 (12
# heads) without mask; T = 48 and 96, the last lengths of the three- and
# six-row-tile instantiations, so that every bf16 instantiation is held to
# the plain version; the edges T = 256 (two passes over key tiles) and T = 1
KERNEL_CASES = [
    ((512, 8, 32, 64), (True, False)),
    ((512, 8, 77, 64), (True, False)),
    ((512, 8, 20, 64), (True, False)),
    ((512, 8, 50, 64), (False,)),
    ((512, 12, 50, 64), (False,)),
    ((64, 12, 197, 64), (False,)),
    ((512, 8, 48, 64), (True, False)),
    ((512, 8, 96, 64), (True, False)),
    ((8, 8, 256, 64), (True, False)),
    ((8, 8, 1, 64), (True, False)),
]
MAIN_SHAPE = (512, 8, 32, 64)                 # the bank build's: 512 prompts, T = 32
# kernel vs plain, elementwise |k - p| <= atol + rtol |p|: fp32 differs only
# in summation order; in bf16 the two may round an output (or a
# probability) to neighbouring bf16 values, about 2^-8 relative
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, warmup=3):
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's cost of issuing each call
    (Python, the wrapper's checks, the launch) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on the card")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {smi_name_power()}")
    return name


def phase_build():
    from hgr_tpu_torch.ops import attention, build

    t0 = time.time()
    logs = build.build(build.all_sources())
    attention._library()
    log(f"[build] {build.all_sources()} in {time.time() - t0:.1f} s -> {build.BUILD_DIR}")
    for line in "\n".join(logs).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def attention_bound_ms(shape, dtype, mask):
    """The least time for attention at ``shape``: q, k, v and the mask read
    once and the output written once, against the two products over the
    scores that the mask leaves live (T(T+1)/2 of T^2 when causal: a -inf
    entry's probability is 0 and needs no work)."""
    B, H, T, Dh = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * H * T * Dh * elem + (0 if mask is None else mask.numel() * 4)
    live = T * T if mask is None else int((mask > float("-inf")).sum())
    flops = 4 * B * H * live * Dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qkv_views(shape, dtype, layout, g, dev):
    """q, k, v as ``mha`` passes them (``packed``: strided views of one
    [B, T, 3, H, Dh] projection) or as separate contiguous [B, H, T, Dh]
    tensors (``contiguous``), so that both stride patterns reach the kernel."""
    B, H, T, Dh = shape
    if layout == "packed":
        qkv = torch.randn((B, T, 3, H, Dh), generator=g, device=dev).to(dtype)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    return [torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3)]


def phase_kernels(dev):
    """K1 against attention_scores on the card, with times and bounds."""
    import torch.nn.functional as F

    from hgr_tpu_torch.models.layers import attention_scores, causal_mask
    from hgr_tpu_torch.ops.attention import attention

    g = torch.Generator(device=dev).manual_seed(0)
    main = None
    for shape, causals in KERNEL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for layout in ("packed", "contiguous"):
                q, k, v = qkv_views(shape, dtype, layout, g, dev)
                for causal in causals:
                    row = check_attention(attention, attention_scores, F.scaled_dot_product_attention,
                                          q, k, v, causal_mask(shape[2], device=dev) if causal else None)
                    name = str(dtype).split(".")[-1]
                    eager = row.pop("eager_ms")
                    log(f"[kernel] attention {shape} {name} {layout} causal={causal}: max_abs_err "
                        f"{row['max_abs_err']:.3e} (tol {TOL[dtype][0]:g} + {TOL[dtype][1]:g}|p|) ok | "
                        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
                        f"| {row['bound_ms'] / row['ms']:.1%} of bound | kernel eager "
                        f"{eager:.4f} ms a call, host included")
                    if shape == MAIN_SHAPE and dtype == torch.bfloat16 and layout == "packed" and causal:
                        main = row
    return main


def check_attention(kernel, plain, sdpa, q, k, v, mask):
    """One case of phase 3: the kernel held to its plain version (raises
    beyond TOL), then the three timed on the device; returns the
    kernel-table fields and ``eager_ms``, the kernel's time a call from
    Python, host included."""
    got = kernel(q, k, v, mask)
    want = plain(q, k, v, mask)
    torch.cuda.synchronize()
    atol, rtol = TOL[q.dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"attention kernel disagrees with its plain version at "
                             f"{tuple(q.shape)} {q.dtype} strides {q.stride()} "
                             f"mask={mask is not None}: {err}")
    causal = mask is not None
    bound, by = attention_bound_ms(tuple(q.shape), q.dtype, mask)
    return dict(
        ms=graph_ms(lambda: kernel(q, k, v, mask)),
        plain_ms=graph_ms(lambda: plain(q, k, v, mask)),
        library_ms=graph_ms(lambda: sdpa(q, k, v, is_causal=causal)),
        bound_ms=bound, bound_by=by, max_abs_err=err,
        eager_ms=cuda_ms(lambda: kernel(q, k, v, mask)),
    )


def phase_slice(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=512, batches=8,
                launches_expected=432, image_launches=0, folder="runs/chip_smoke"):
    """The zero-shot eval path at full width; returns (tm, bank, summary,
    K1 launches during run_test). ``launches_expected`` is K1's count in
    one bank build, ``image_launches`` its count in one image batch."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.driver import build_model, run_test, synthetic_splits
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.utils.logging import RunLogger

    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    cfg = Config(arch=arch, synthetic=True, train=False, test_batch_size=batch,
                 synthetic_images_per_class=batch, max_test_batches=batches, folder=folder)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    splits = synthetic_splits(hier, cfg.seed)
    t0 = time.time()
    tm = build_model(cfg, hier, splits, device=dev)
    log(f"[slice] {arch}: {hier.num_nodes} classes, bank rows {tm.n_pad}, tokens T = "
        f"{tm.node_tokens.shape[1]}; model built in {time.time() - t0:.1f} s")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the bank alone, timed
    attention.launches = 0
    sync()
    t0 = time.time()
    bank = tm.update_classifier()
    sync()
    bank_ms = (time.time() - t0) * 1e3
    n = attention.launches
    log(f"[slice] bank build {bank_ms:.1f} ms on {name}; K1 launches {n}")
    assert n == launches_expected, f"K1 launched {n} times in the bank build, not {launches_expected}"
    assert bank.shape == (tm.n_pad, tm.clip_cfg.embed_dim), bank.shape
    assert bool(torch.isfinite(bank).all()), "bank not finite"

    # the main path: counts reset just before, read just after
    attention.launches = 0
    summary = run_test(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    launches = attention.launches
    log(f"[slice] run_test: {json.dumps(summary)}")
    log(f"[slice] K1 launches during run_test: {launches}")
    want = launches_expected + image_launches * batches
    assert launches == want, f"K1 launched {launches} times in run_test, not {want}"
    assert summary["num_samples"] == batches * batch, summary["num_samples"]
    assert all(math.isfinite(v) for v in summary.values()), summary

    # per-batch eval step on a batch already on the device
    bank_s = tm.sort_bank(bank)
    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((batch, res, res, 3), generator=gen, device=dev)
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    target = int(tm.test_index[0])
    if dev.type == "cuda":
        step_ms = cuda_ms(lambda: tm.eval_step_sorted(bank_s, images, target, valid), reps=5, warmup=2)
        log(f"[slice] eval step {step_ms:.2f} ms per batch of {batch} = "
            f"{batch / step_ms * 1e3:.0f} images/s (device-resident batch); run_test "
            f"{summary['imgs_per_sec']:.0f} images/s with the synthetic loader; on {name}; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return tm, bank, summary, launches


def phase_plain_bank(tm, bank):
    """Rebuild the bank with the plain attention and hold it to K1's."""
    from hgr_tpu_torch.models.layers import attention_scores

    plain = tm.update_classifier(attn_fn=attention_scores)
    cos = torch.nn.functional.cosine_similarity(bank.float(), plain.float(), dim=-1)
    err = float((bank.float() - plain.float()).abs().max())
    log(f"[bank] kernel vs plain attention, bf16: max_abs_err {err:.3e} (tol 1e-2), "
        f"min row cosine {float(cos.min()):.6f} (tol 0.999)")
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "kernel bank disagrees with plain bank"


def phase_small_reference(tm, bank):
    """float32 on the card (K1, cuDNN, cuBLAS; TF32 off) against the port's
    CPU path with the same weights: text features, image features, and one
    eval step's metric sums."""
    from hgr_tpu_torch.eval.bank import bank_logits
    from hgr_tpu_torch.models.clip import encode_image, encode_text
    from hgr_tpu_torch.tree_model import TreeModel

    dev = tm.device
    cpu = TreeModel.build(tm.config.replace(dtype="float32"), tm.hier,
                          [tm.hier.names[i] for i in tm.train_index],
                          [tm.hier.names[i] for i in tm.test_index],
                          pad_multiple=tm.n_pad, seed=tm.config.seed, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in tm.model.state_dict().items()})
    gpu = dataclasses.replace(tm, config=tm.config.replace(dtype="float32"))

    def close(name, a, b, rel):
        err = float((a.cpu().float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        log(f"[small] {name}: max_abs_err {err:.3e} (tol {rel:g} x {scale:.3e})")
        assert err <= rel * scale, f"{name}: card and CPU disagree"

    toks = torch.as_tensor(tm.node_tokens[:256])
    with torch.inference_mode():
        close("text features, 256 prompts",
              encode_text(tm.model, toks.to(dev), dtype=torch.float32),
              encode_text(cpu.model, toks, dtype=torch.float32), 1e-4)
        gen = torch.Generator().manual_seed(2)
        res = tm.clip_cfg.image_resolution
        images = torch.randn((4, res, res, 3), generator=gen)
        feats = encode_image(cpu.model, images, dtype=torch.float32)
        close("image features, 4 images",
              encode_image(tm.model, images.to(dev), dtype=torch.float32), feats, 1e-4)
        logits = bank_logits(feats, bank.cpu())
        close("cosine logits against the bank", bank_logits(feats.to(dev), bank), logits, 1e-4)
        # the unseen class the first image ranks highest, so that the counts
        # compared below are not all zero
        test = torch.as_tensor(tm.test_mask)
        target = int(torch.where(test, logits[0], float("-inf")).argmax())
        bank_s = tm.sort_bank(bank)
        got = gpu.eval_step_sorted(bank_s, images.to(dev), target)
        want = cpu.eval_step_sorted(bank_s.cpu(), images, target)
    got = [t.cpu().tolist() for t in got]
    want = [t.tolist() for t in want]
    log(f"[small] eval step sums (hits, tor, path, point, num): card {got}, cpu {want}")
    # counts exact; path and point are fp32 sums of fractions
    assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4], "counts differ"
    assert got[0][0] > 0, "the chosen target was never ranked first"
    for a, b in zip(got[2:4], want[2:4]):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), "path/point sums differ"


def phase_vit_features(tm, batch=512):
    """One batch of ViT image features through K1, held to the plain
    attention's; both L2-normalised, as ``bank_logits`` uses them."""
    from hgr_tpu_torch.models.clip import encode_image
    from hgr_tpu_torch.models.layers import attention_scores, l2_normalize

    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=tm.device).manual_seed(3)
    images = torch.randn((batch, res, res, 3), generator=gen, device=tm.device)
    with torch.inference_mode():
        got = l2_normalize(encode_image(tm.model, images, dtype=tm.dtype)).float()
        want = l2_normalize(encode_image(tm.model, images, dtype=tm.dtype,
                                         attn_fn=attention_scores)).float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    err = float((got - want).abs().max())
    log(f"[vit] {batch} images, normalised features, kernel vs plain attention, bf16: "
        f"max_abs_err {err:.3e} (tol 1e-2), min row cosine {float(cos.min()):.6f} (tol 0.999)")
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "ViT features through K1 disagree"


def phase_train(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=256, num_compare=256,
                episodes=4, test_batches=2, bank_launches=432, folder="runs/chip_smoke_train"):
    """OM training at full width through ``driver.run_train``; returns K1's
    launches (inside the train steps, in the test after them)."""
    import os
    import shutil

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.models.clip import clip_init
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.train import ScheduleBuilder, init_train_state, make_optimizer
    from hgr_tpu_torch.utils.checkpoint import restore_checkpoint
    from hgr_tpu_torch.utils.logging import RunLogger

    cfg = Config(arch=arch, synthetic=True, train=True, remat=True, batch_size=batch,
                 num_compare=num_compare, epochs=1, n_episodes=episodes,
                 test_after_train=True, max_test_batches=test_batches, test_batch_size=batch,
                 synthetic_images_per_class=batch, print_freq=1, folder=folder)
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    splits = driver.synthetic_splits(hier, cfg.seed)
    tm = driver.build_model(cfg, hier, splits, device=dev)
    sd = tm.model.state_dict()
    watched = [k for k in ("visual.conv1.weight", "visual.bn1.running_var",
                           "visual.attnpool.c_proj.weight", "visual.proj",
                           "transformer.resblocks.0.attn.in_proj_weight", "logit_scale")
               if k in sd]
    before = {k: sd[k].clone() for k in watched}
    lw_before = tm.layer_weight.detach().clone()

    # spies on the path, not on what it computes: K1's count when the test
    # after training starts, and the prompts each schedule asks to encode
    seen = {}
    prompts = []
    real_run_test, real_build = driver.run_test, ScheduleBuilder.build

    def run_test_spy(*a, **kw):
        seen["train_steps"] = attention.launches
        out = real_run_test(*a, **kw)
        seen["test"] = attention.launches - seen["train_steps"]
        return out

    def build_spy(self, target):
        sched = real_build(self, target)
        prompts.append((len(np.unique(sched.compare[sched.compare_valid])), len(sched.unique)))
        return sched

    logger = RunLogger(cfg.save_path, echo=False)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    driver.run_test, ScheduleBuilder.build = run_test_spy, build_spy
    attention.launches = 0
    t0 = time.time()
    try:
        state = driver.run_train(cfg, tm, splits, logger)
    finally:
        driver.run_test, ScheduleBuilder.build = real_run_test, real_build
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else float("nan")

    records = [json.loads(line) for line in open(logger.jsonl_path)]
    train = [r for r in records if r["event"] == "train"]
    losses = [r["loss"] for r in train]
    step_ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(train, train[1:])]
    med = statistics.median(step_ms)
    perf = [r for r in records if r["event"] == "epoch_perf"][0]
    log(f"[train] {arch} bf16 remat, batch {batch}, {num_compare} negatives, {hier.num_nodes} "
        f"classes (bank rows {tm.n_pad}), {len(losses)} steps in {wall:.1f} s of run_train")
    log(f"[train] losses {losses}")
    log(f"[train] step ms after the first: {[round(x, 1) for x in step_ms]}, median {med:.1f} ms "
        f"= {batch / med * 1e3:.1f} images/s; epoch_perf {perf['step_ms']} ms a step over all "
        f"steps, {perf['imgs_per_sec']} images/s; prompts a step (distinct, encoded) {prompts}; "
        f"peak memory {peak:.2f} GiB; on {torch.cuda.get_device_name(0) if on_card else 'cpu'}")
    assert len(losses) == episodes and all(math.isfinite(x) for x in losses), losses
    sd = tm.model.state_dict()
    for k in watched:
        assert not torch.equal(sd[k], before[k]), f"{k} did not move"
    assert not torch.equal(tm.layer_weight.detach(), lw_before), "layer_weight did not move"
    log(f"[train] K1 launches: {seen['train_steps']} inside the train steps, "
        f"{seen['test']} in the test after them")
    assert seen["train_steps"] == 0, "K1 ran inside a train step"
    assert seen["test"] == bank_launches, seen

    fresh = init_train_state(clip_init(tm.clip_cfg, torch.Generator().manual_seed(1), dev),
                             torch.zeros_like(tm.layer_weight),
                             make_optimizer(cfg, cfg.epochs * episodes))
    restore_checkpoint(os.path.join(cfg.save_path, "clip_0"), fresh)
    got = fresh.params["clip"].state_dict()
    same = all(torch.equal(got[k], v) for k, v in sd.items())
    same = same and torch.equal(fresh.params["layer_weight"], tm.layer_weight.detach())
    adam_got, adam_want = (o.adamw.state_dict()["state"][0]["exp_avg_sq"]
                           for o in (fresh.opt_state, state.opt_state))
    log(f"[train] clip_0 restored into a fresh train state: params equal {same}, step "
        f"{fresh.step}, updates {fresh.opt_state.count}")
    assert same and fresh.step == episodes and fresh.opt_state.count == episodes
    assert torch.equal(adam_got, adam_want), "optimizer moments not restored"
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    return seen


def phase_train_reference(dev):
    """One OM train step in float32 on the card and on the port's CPU path
    from the same weights, images and schedule (TEST-ViT, remat on): the
    loss within 1e-5 relative, the updated weights within 5e-3 relative +
    3e-5 wherever the gradient is above 1e-6 (AdamW's first step is about
    lr * sign(g), so a gradient at rounding level may flip its sign)."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import synthetic_hierarchy
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, freeze_params,
                                     init_train_state, make_om_loss_fn, make_optimizer,
                                     make_train_step, sched_to_device)
    from hgr_tpu_torch.tree_model import TreeModel

    cfg = Config(arch="TEST-ViT", dtype="float32", batch_size=4, num_compare=6, remat=True,
                 lr=1e-3, w_lr=1e-2)
    hier = synthetic_hierarchy(3, 4, 5, 0)
    sides = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        tm = TreeModel.build(cfg, hier, pad_multiple=64, device=device)
        if name == "cpu":
            tm.init_params(0)
            weights = tm.model.state_dict()
        else:
            tm.load_state_dict(weights)
        sides[name] = tm
    target = int(hier.level(hier.max_depth)[3])
    sched = ScheduleBuilder(hier, NegativeSampler(hier, sides["cpu"].train_index, 6, seed=0),
                            cfg.out_ratio, cfg.in_ratio, 6).build(target)
    images = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)

    cpu = sides["cpu"]
    params = freeze_params({"clip": cpu.model, "layer_weight": cpu.layer_weight}, ())
    loss_fn = make_om_loss_fn(torch.float32, cfg.training_method, cfg.weights, cfg.weighting,
                              remat=True)
    loss_fn(params, torch.from_numpy(images), torch.as_tensor(cpu.node_tokens).long(),
            sched_to_device(sched, "cpu")).backward()
    grads = {k: v.grad.clone() for k, v in cpu.model.state_dict(keep_vars=True).items()}
    for v in cpu.model.state_dict(keep_vars=True).values():
        v.grad = None
    cpu.layer_weight.grad = None

    out = {}
    for name, tm in sides.items():
        tx = make_optimizer(cfg, 10)
        state = init_train_state(tm.model, tm.layer_weight, tx)
        step = make_train_step(cfg, tx, dtype=torch.float32)
        _, loss = step(state, torch.from_numpy(images).to(tm.device),
                       torch.as_tensor(tm.node_tokens, device=tm.device).long(),
                       sched_to_device(sched, tm.device))
        out[name] = (float(loss), {k: v.cpu() for k, v in tm.model.state_dict().items()},
                     tm.layer_weight.detach().cpu())
    (lc, pc, wc), (lg, pg, wg) = out["cpu"], out["card"]
    rel = abs(lg - lc) / abs(lc)
    worst = float("-inf")
    for k, g in grads.items():
        m = g.abs() > 1e-6
        excess = (pg[k][m] - pc[k][m]).abs() - (3e-5 + 5e-3 * pc[k][m].abs())
        worst = max(worst, float(excess.max()) if m.any() else -1.0)
    lw_err = float((wg - wc).abs().max())
    log(f"[train-small] one float32 OM step, card vs cpu: loss {lg:.7f} vs {lc:.7f} (rel "
        f"{rel:.2e}, tol 1e-5); updated weights: largest excess over 3e-5 + 5e-3|w| "
        f"{worst:.3e} (must be <= 0); layer_weight max_abs_err {lw_err:.2e}")
    assert rel <= 1e-5 and worst <= 0 and lw_err <= 3e-5 + 5e-3 * float(wc.abs().max())


def phase_guard(dev):
    """K1 refuses a call that autograd would record: it has no backward."""
    from hgr_tpu_torch.ops.attention import attention

    q = torch.randn(2, 2, 8, 64, device=dev, requires_grad=True)
    n = attention.launches
    try:
        attention(q, q.detach(), q.detach())
    except RuntimeError as e:
        log(f"[guard] attention on CUDA tensors that require grad raises: {e}")
    else:
        raise AssertionError("attention ran under autograd")
    assert attention.launches == n
    with torch.no_grad():
        attention(q, q, q)
    assert attention.launches == n + 1


def main() -> int:
    name = phase_device()
    phase_build()
    from hgr_tpu_torch.device import select_device

    dev = select_device("cuda:0")
    main_row = phase_kernels(dev)
    tm, bank, _, rn50 = phase_slice(dev)
    phase_plain_bank(tm, bank)
    phase_small_reference(tm, bank)
    del tm, bank
    vit, _, _, vit_launches = phase_slice(dev, arch="ViT-B/32", batches=2, image_launches=12)
    phase_vit_features(vit)
    del vit
    train = phase_train(dev)
    phase_train_reference(dev)
    phase_guard(dev)

    by_path = {"rn50_eval": rn50, "vit_b32_eval": vit_launches,
               "rn50_train_steps": train["train_steps"], "rn50_test_after_train": train["test"]}
    kernels = [dict(
        name="attention",
        route="cuda",
        source="hgr_tpu_torch/csrc/attention.cu",
        replaces="hgr_tpu/ops/attention.py:28",
        launches=sum(by_path.values()),
        launches_by_path=by_path,
        **main_row,
    )]
    log(json.dumps({"kernels": kernels}))
    log(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
