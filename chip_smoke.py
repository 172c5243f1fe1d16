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
4. the ancestor chains of the smoke's hierarchy, held to the JAX package's
   with networkx by their digest (``EXPECTED_CHAINS_SHA256``);
5. zero-shot eval at full width: RN50, the 18,278-class bank padded to
   18,432, ``run_test`` over 8 batches of 512 synthetic images; K1's launch
   count over that run must be 12 layers x 36 chunks = 432;
6. the class bank rebuilt with the plain attention, held to the kernel's;
7. the card against the port's CPU path (the one the CPU tests hold to the
   JAX package) on a small input, in float32;
8. ViT-B/32 eval at full width against the same bank: ``run_test`` over 2
   batches of 512, where K1 also runs the image tower (T = 50, no mask, 12
   layers), so 432 + 12 x 2 = 456 launches; one batch's features through K1
   held to the plain attention's;
9. real inputs at RN50 width: the hierarchy as ``graph_edges_cls.json``,
   the splits, 18,278 word-like names, a BPE merges table learned from the
   prompts, an OpenAI-layout ``.pt`` and a decode cache of 2,048 seeded
   rows at 224 px, all written to a temporary directory; then
   ``build_hierarchy``, ``build_model``, ``load_torch`` and ``run_test``
   from the cache (the bank cut to T = 32, 432 K1 launches, 2,048 images;
   the first test class is the one the weights give a probe batch, so the
   hits depend on the weights), and the CLI's ``--load`` run in a
   subprocess, whose metrics must equal the in-process run's;
10. files and serving, where the machine can decode (it says which
    decoder, or why it skips): the corrupt fixture's fallback,
    ``classify_files`` over the fixtures tiled to 64 paths (432 K1
    launches), and ``python -m hgr_tpu_torch.serve`` on three of them,
    whose ids and scores must be ``classify_files``'s on the same three;
11. OM training at full width: ``driver.run_train`` on RN50 in bf16 with
    remat, batch 256, 256 negatives, 4 episodes, then ``run_test`` over 2
    batches; every loss finite, the CLIP weights and ``layer_weight`` moved,
    no K1 launch inside a train step (autograd runs the plain attention)
    and 432 in the test after it, and ``clip_0`` restores into a fresh
    train state; prints the steps' median time, images/s, the prompts
    encoded per step and peak memory;
12. one OM train step in float32 on the card against the port's CPU path
    (small TEST-ViT config, the same weights and schedule): the loss and the
    updated weights agree within the CPU tests' tolerances;
13. K1's guard: a CUDA call that autograd would record raises.

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
# sha256 of ``ancestors.tobytes()`` of profiled_hierarchy(LEVEL_SIZES, seed=0,
# cross_edges=40): the JAX package's chains with networkx, which the port's
# own search must reproduce on any machine (tests/test_torch_text.py)
EXPECTED_CHAINS_SHA256 = "2a5a9b8e9cab7e26f191b66e70adcc0c5d94697024b01f6a5c2eb824444771a4"
SYLLABLES = ("ka", "lo", "mi", "ren", "sto", "vel", "dar", "qui", "ton", "bra", "el", "fin",
             "gor", "hal", "is", "jun", "ker", "lum", "mor", "nes", "ox", "pra", "rul", "sen",
             "tri", "ul", "vor", "wen", "yal", "zet", "an", "cor")
# kernel vs plain, elementwise |k - p| <= atol + rtol |p|: fp32 differs only
# in summation order; in bf16 the two may round an output (or a
# probability) to neighbouring bf16 values, about 2^-8 relative
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# copies of one file at other rows of one bf16 batch of 64: their scores
# differ by rounding; on an H100 the largest gap measured 9.6e-5, about 1.5
# bf16 steps at these scores (about 0.015), and the bound is 4x that
DUP_ROW_ATOL = 4e-4


def log(*a):
    print(*a, flush=True)


def word_names(wnids, seed=0):
    """{wnid: name}: WordNet-like names of one to three words, each word two
    to four syllables, drawn from ``seed`` (distinct per wnid)."""
    rng = np.random.default_rng(seed)
    out, used = {}, set()
    for w in wnids:
        while True:
            name = " ".join("".join(rng.choice(SYLLABLES, rng.integers(2, 5)))
                            for _ in range(rng.integers(1, 4)))
            if name not in used:
                used.add(name)
                out[w] = name
                break
    return out


def learn_merges(texts, n_merges, sample=2000, seed=0):
    """A BPE merge table learned from ``texts`` (a seeded sample of at most
    ``sample`` of them) by the plain pair-count loop: split into words as
    the tokenizer splits, then ``n_merges`` times merge the most frequent
    adjacent pair (ties to the larger pair)."""
    from collections import Counter

    from hgr_tpu_torch.text.bpe import _clean, _patterns, bytes_to_unicode

    be = bytes_to_unicode()
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(texts), min(sample, len(texts)), replace=False)
    words = Counter()
    for i in sorted(pick):
        for tok in _patterns()[0].findall(_clean(texts[i])):
            chars = [be[b] for b in tok.encode("utf-8")]
            words[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def write_merges(path, merges):
    """A merges file as ``load_merges`` reads it: a header line, then one
    pair a line, gzipped."""
    import gzip

    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: learned by chip_smoke.learn_merges\n")
        f.write("\n".join(f"{a} {b}" for a, b in merges) + "\n")


def chains_digest(hier) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(hier.ancestors).tobytes()).hexdigest()


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


class SeededRows:
    """An image source of seeded uint8 rows, keyed by the image's path: what
    the decode cache is built from where no image files exist."""

    def __init__(self, resolution):
        self.resolution = resolution

    def load(self, class_name, paths, idx):
        import zlib

        rng = np.random.default_rng(zlib.crc32(paths[idx].encode()))
        return rng.integers(0, 256, (self.resolution, self.resolution, 3), dtype=np.uint8)


def phase_chains():
    """The port's ancestor chains of the smoke's hierarchy are the JAX
    package's with networkx (``EXPECTED_CHAINS_SHA256``)."""
    from hgr_tpu_torch.hierarchy import profiled_hierarchy

    digest = chains_digest(profiled_hierarchy(LEVEL_SIZES, seed=0, cross_edges=40))
    log(f"[chains] sha256 of the ancestor chains {digest}: "
        f"{'equals' if digest == EXPECTED_CHAINS_SHA256 else 'DIFFERS FROM'} the JAX package's "
        f"(with networkx) {EXPECTED_CHAINS_SHA256}")
    assert digest == EXPECTED_CHAINS_SHA256, "the port's ancestor chains differ from JAX's"


def _final_eval(save_path):
    recs = [json.loads(line) for line in open(f"{save_path}/metrics.jsonl")]
    return [r for r in recs if r["event"] == "eval" and r["tag"] == "final"][-1]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_real_inputs(dev, work, arch="RN50", level_sizes=LEVEL_SIZES, per_class=512,
                      batch=512, n_merges=400, bank_launches=432, synthetic_ips=None):
    """The eval path on the files a user holds, at full width: writes the
    hierarchy's ``graph_edges_cls.json``, the splits, a names JSON, a BPE
    merges table learned from the prompts and an OpenAI-layout ``.pt`` with
    seeded weights; then ``build_hierarchy``, ``build_model`` and
    ``load_torch``. With random weights every metric would be 0 and so
    would not show which weights ran: the first of the 4 unseen test classes
    is the one these weights give most often to a batch of seeded rows, and
    those rows are its images. The hops split of the 4 classes and a decode
    cache of their 4 x ``per_class`` rows follow, then ``run_test`` from the
    cache, which must score the chosen class's hits, and the CLI's
    ``--load`` run on the same weights saved as ``clip_0``, which must give
    the same metrics. Returns what the serving phase needs and K1's launches
    in ``run_test``."""
    import os
    import time as _time
    from collections import Counter

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.data import GroupedTestLoader
    from hgr_tpu_torch.data.decode_cache import CachedImageSource, build_cache
    from hgr_tpu_torch.hierarchy import Hierarchy, profiled_edges
    from hgr_tpu_torch.models.clip import clip_init, get_config
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.serve import ZeroShotClassifier
    from hgr_tpu_torch.text import Tokenizer
    from hgr_tpu_torch.train import init_train_state, make_optimizer
    from hgr_tpu_torch.tree_model import node_prompts
    from hgr_tpu_torch.utils.checkpoint import save_checkpoint
    from hgr_tpu_torch.utils.logging import RunLogger

    t_start = _time.time()
    path = {k: os.path.join(work, v) for k, v in dict(
        graph="graph_edges_cls.json", splits="splits_for_tree.json", hops="splits_for_hops.json",
        names="names.json", vocab="bpe_learned.txt.gz", pt="openai_layout.pt",
        manifest="zsl_test_split.json", cache="decode_cache", runs="runs").items()}
    edges = profiled_edges(level_sizes, seed=0, cross_edges=40)
    hier = Hierarchy.from_edges(edges)
    names = word_names(hier.names, seed=0)
    # the test classes are chosen below, once the weights are loaded
    for key, obj in (("graph", edges), ("splits", driver.synthetic_splits(hier, 0)),
                     ("hops", {"smoke_test": []}), ("names", names)):
        with open(path[key], "w") as f:
            json.dump(obj, f)
    write_merges(path["vocab"],
                 learn_merges(node_prompts(hier, Config().template, names), n_merges))
    clip_cfg = get_config(arch)
    sd = clip_init(clip_cfg, torch.Generator().manual_seed(1)).state_dict()
    sd = {k: v.half() for k, v in sd.items()}  # OpenAI ships fp16 tensors
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    torch.save(sd, path["pt"])
    log(f"[real] inputs written in {_time.time() - t_start:.1f} s: {len(edges)} edges, "
        f"{n_merges} merges, {os.path.getsize(path['pt']) / 1e6:.1f} MB of weights")

    args = ["--arch", arch, "--synthetic", "False", "--train", "False",
            "--graph_path", path["graph"], "--split_path", path["splits"],
            "--hops_path", path["hops"], "--data_test", "smoke_test",
            "--vocab_path", path["vocab"], "--names_path", path["names"],
            "--decode_cache", path["cache"], "--test_batch_size", str(batch),
            "--folder", path["runs"], "--print_freq", "1000"]
    cfg = Config.from_args(args)
    hier, splits = driver.build_hierarchy(cfg)
    # a spy on the path, not on what it computes: the time and the lengths
    # of build_model's one tokenize call over the node prompts
    seen = {}
    real_tokenize = Tokenizer.tokenize

    def tokenize_spy(self, texts, *a, **kw):
        t0 = _time.time()
        out = real_tokenize(self, texts, *a, **kw)
        seen.update(ms=(_time.time() - t0) * 1e3, n=len(texts), lens=(out != 0).sum(1))
        return out

    Tokenizer.tokenize = tokenize_spy
    t0 = _time.time()
    try:
        tm = driver.build_model(cfg, hier, splits, device=dev)
    finally:
        Tokenizer.tokenize = real_tokenize
    build_s = _time.time() - t0
    lens = seen["lens"]
    t_cut = tm.node_tokens.shape[1]
    want_cut = max(16, -(-int(lens.max()) // 16) * 16)
    log(f"[real] tokenize {seen['n']} prompts {seen['ms']:.1f} ms (host, in build_model, which "
        f"took {build_s:.1f} s); BPE tokens a prompt {int(lens.min())}-{int(lens.max())} (mean "
        f"{lens.mean():.1f}); bank cut to T = {t_cut}")
    assert t_cut == want_cut and int(lens.min()) >= 8, (t_cut, want_cut, int(lens.min()))
    t0 = _time.time()
    tm.load_torch(path["pt"])
    log(f"[real] load_torch({os.path.basename(path['pt'])}) in {_time.time() - t0:.1f} s: "
        f"{tm.clip_cfg}")
    _sync(dev)
    t0 = _time.time()
    bank = tm.update_classifier()
    _sync(dev)
    bank_ms = (_time.time() - t0) * 1e3
    assert bool(torch.isfinite(bank).all())

    # the class these weights give most often to one batch of seeded rows,
    # among the unseen classes that the metrics rank
    res = clip_cfg.image_resolution
    rows = SeededRows(res)
    probe = [f"probe/{j:04d}.JPEG" for j in range(per_class)]
    clf = ZeroShotClassifier(tm, candidates="test")
    clf.bank_sorted = tm.sort_bank(bank)
    del bank
    top1, _ = clf.classify(np.stack([rows.load("", probe, j)
                                     for j in range(min(batch, per_class))]), k=1)
    (chosen, n_chosen), = Counter(top1[:, 0].tolist()).most_common(1)
    del clf
    rest = [c for c in splits["rest"] if c != hier.names[chosen]]
    test4 = [hier.names[chosen]] + [rest[i * len(rest) // 3] for i in range(3)]
    grouped = {c: [f"{c}/{j:04d}.JPEG" for j in range(per_class)] for c in test4[1:]}
    grouped = {test4[0]: probe, **grouped}
    for key, obj in (("hops", {"smoke_test": test4}), ("manifest", grouped)):
        with open(path[key], "w") as f:
            json.dump(obj, f)
    t0 = _time.time()
    build_cache(grouped, os.path.join(path["cache"], "zsl_test"), res, source=rows)
    nbytes = os.path.getsize(os.path.join(path["cache"], "zsl_test", "images.u8"))
    log(f"[real] the weights give {n_chosen} of {len(top1)} seeded rows to {test4[0]} (node "
        f"{chosen}): its test images; decode cache of {4 * per_class} rows at {res} px "
        f"({nbytes / 1e6:.1f} MB, built in {_time.time() - t0:.1f} s)")
    hier, splits = driver.build_hierarchy(cfg)
    assert splits["smoke_test"] == test4
    assert chains_digest(hier) == EXPECTED_CHAINS_SHA256 or level_sizes != LEVEL_SIZES

    # the main path: counts reset just before, read just after
    attention.launches = 0
    summary = driver.run_test(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    launches = attention.launches
    log(f"[real] run_test from the decode cache: {json.dumps(summary)}")
    log(f"[real] K1 launches during run_test: {launches} (T = {t_cut})")
    assert launches == bank_launches, f"K1 launched {launches} times, not {bank_launches}"
    num = summary["num_samples"]
    assert num == 4 * per_class, num
    assert all(math.isfinite(v) for v in summary.values()), summary
    # the chosen class's first batch is the probe batch: its hits at least
    hits1 = round(summary["hit@1"] * num / 100)
    assert hits1 >= n_chosen, f"{hits1} hits at 1, fewer than the {n_chosen} of the probe"

    src = CachedImageSource(os.path.join(path["cache"], "zsl_test"), expected_resolution=res)
    loader = GroupedTestLoader(grouped, {c: hier.name_to_id[c] for c in grouped}, src, batch,
                               num_threads=cfg.num_workers)
    t0 = _time.time()
    n = sum(1 for _ in loader)
    read_ms = (_time.time() - t0) * 1e3 / n
    loader.close()
    log(f"[real] bank build {bank_ms:.1f} ms ({seen['n']} prompts, T = {t_cut}); run_test "
        f"{summary['imgs_per_sec']:.0f} images/s from the decode cache"
        + (f" against {synthetic_ips:.0f} with the synthetic loader" if synthetic_ips else "")
        + f"; cache read {read_ms:.1f} ms per batch of {batch} (loader alone, "
        f"{cfg.num_workers} threads); on {torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'}")

    # the CLI on the same weights, saved as clip_0
    save_checkpoint(cfg.save_path, 0, init_train_state(tm.model, tm.layer_weight,
                                                       make_optimizer(cfg, 1)))
    cli = args + ["--load", "True", "--from_epoch", "0"]
    if dev.type == "cuda":
        cli += ["--device", str(dev.index or 0)]
    t0 = _time.time()
    p = subprocess.run([sys.executable, "-m", "hgr_tpu_torch", *cli], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    got = _final_eval(cfg.save_path)
    keys = [k for k in summary if k != "imgs_per_sec"]
    same = all(got[k] == summary[k] for k in keys)
    log(f"[real] CLI `python -m hgr_tpu_torch --synthetic False --train False --load True "
        f"--from_epoch 0 ...` in {_time.time() - t0:.1f} s: metrics equal to the in-process "
        f"run: {same} ({ {k: got[k] for k in keys} })")
    assert same, (got, summary)
    return dict(tm=tm, args=cli, names=names, launches=launches)


def phase_files_and_serving(real, fixtures=None):
    """Files through ``FileImageSource`` and serving, when this machine can
    decode: the decoder in use and its time per image, the corrupt file's
    fallback, ``classify_files`` over the fixtures tiled to 64 paths (K1
    rebuilds the bank), and ``python -m hgr_tpu_torch.serve`` on three of
    them. Returns K1's launches in ``classify_files``, or None when no
    decoder exists (the check that needs none ran in the real-input phase)."""
    import time as _time
    from pathlib import Path

    from hgr_tpu_torch.data import FileImageSource
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.serve import ZeroShotClassifier

    tm = real["tm"]
    fixtures = Path(fixtures or Path(__file__).resolve().parent / "tests" / "torch_fixtures")
    good = sorted(str(p) for p in fixtures.iterdir()
                  if p.suffix in (".jpg", ".png") and p.name != "corrupt.jpg")
    res = tm.clip_cfg.image_resolution
    try:
        src = FileImageSource(res)
    except RuntimeError as e:
        log(f"[files] skipped: this machine has no image decoder ({e}); the decode-cache path "
            "above needs none")
        return None
    decoder = "native libjpeg" if src.native else "PIL"
    t0 = _time.time()
    for _ in range(5):
        for f in good:
            src.load("c", [f], 0)
    per_img = (_time.time() - t0) * 1e3 / (5 * len(good))
    fallback = src.load("c", [good[0], str(fixtures / "corrupt.jpg")], 1)
    assert np.array_equal(fallback, src.load("c", [good[0]], 0)), "corrupt-file fallback"
    log(f"[files] decoder {decoder}: {per_img:.2f} ms an image ({len(good)} fixtures at {res} px, "
        "one thread, host); corrupt.jpg gives its class's first image")

    paths = (good * 64)[:64]
    clf = ZeroShotClassifier(tm)
    attention.launches = 0
    out = clf.classify_files(paths, k=5, batch=64)
    launches = attention.launches
    first, gap, moved = {}, 0.0, 0
    for p, row in zip(paths, out):
        assert len(row) == 5 and all(math.isfinite(s) for _, s in row), row
        # copies of one file at other rows of the bf16 batch
        want = first.setdefault(p, row)
        gap = max(gap, max(abs(s - w) for (_, s), (_, w) in zip(row, want)))
        moved += [c for c, _ in row] != [c for c, _ in want]
    log(f"[files] classify_files over {len(paths)} paths: K1 launches {launches}; copies of one "
        f"file at other rows of the batch: largest score gap {gap:.3e}, top-5 order changed in "
        f"{moved} of {len(paths) - len(good)}; top-1 {[first[p][0] for p in good]}")
    assert gap <= DUP_ROW_ATOL, f"copies of one file differ by {gap:.3e} > {DUP_ROW_ATOL}"
    assert launches == 432 or tm.n_pad != 18432, launches

    # the CLI against classify_files at its batch shape (3 rows) and weights
    three = good[:3]
    want = clf.classify_files(three, k=3)
    t0 = _time.time()
    p = subprocess.run([sys.executable, "-m", "hgr_tpu_torch.serve",
                        *[Path(f).name for f in three], *real["args"], "--k", "3",
                        "--image_root", str(fixtures)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith('{"image"')]
    assert [x["image"] for x in lines] == [Path(f).name for f in three], p.stdout[-2000:]
    worst = 0.0
    for x, row in zip(lines, want):
        top = x["topk"]
        assert [t["wnid"] for t in top] == [w for w, _ in row], (top, row)
        assert all(t["name"] == real["names"][t["wnid"]] for t in top), top
        # the CLI prints scores rounded to 4 places
        worst = max(worst, max(abs(t["score"] - s) for t, (_, s) in zip(top, row)))
    log(f"[files] `python -m hgr_tpu_torch.serve` on {len(three)} fixtures in "
        f"{_time.time() - t0:.1f} s: {len(lines)} JSON lines, top-3 ids those of classify_files "
        f"on the same 3 files, scores within {worst:.1e} (tol 1e-4); first line "
        f"{json.dumps(lines[0])}")
    assert worst <= 1e-4, worst
    return launches


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
    import shutil
    import tempfile

    name = phase_device()
    phase_build()
    from hgr_tpu_torch.device import select_device

    dev = select_device("cuda:0")
    main_row = phase_kernels(dev)
    phase_chains()
    tm, bank, summary, rn50 = phase_slice(dev)
    phase_plain_bank(tm, bank)
    phase_small_reference(tm, bank)
    del tm, bank
    vit, _, _, vit_launches = phase_slice(dev, arch="ViT-B/32", batches=2, image_launches=12)
    phase_vit_features(vit)
    del vit
    work = tempfile.mkdtemp(prefix="hgr_real_inputs_")
    try:
        real = phase_real_inputs(dev, work, synthetic_ips=summary["imgs_per_sec"])
        serving = phase_files_and_serving(real)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    real_launches = real.pop("launches")
    del real
    train = phase_train(dev)
    phase_train_reference(dev)
    phase_guard(dev)

    by_path = {"rn50_eval": rn50, "vit_b32_eval": vit_launches,
               "rn50_real_inputs_eval": real_launches,
               **({} if serving is None else {"rn50_serve_classify_files": serving}),
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
