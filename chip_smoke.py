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
4. the slice at full width: RN50, the 18,278-class bank padded to 18,432,
   ``run_test`` over 8 batches of 512 synthetic images; K1's launch count
   over that run must be 12 layers x 36 chunks = 432;
5. the class bank rebuilt with the plain attention, held to the kernel's;
6. the card against the port's CPU path (the one the CPU tests hold to the
   JAX package) on a small input, in float32.

The second-to-last lines are the kernel table (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

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
                launches_expected=432, folder="runs/chip_smoke"):
    """The zero-shot eval path at full width; returns (tm, bank, summary,
    K1 launches during run_test)."""
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
    log(f"[slice] {hier.num_nodes} classes, bank rows {tm.n_pad}, tokens T = "
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
    assert launches == launches_expected, f"K1 launched {launches} times in run_test"
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


def main() -> int:
    name = phase_device()
    phase_build()
    from hgr_tpu_torch.device import select_device

    dev = select_device("cuda:0")
    main_row = phase_kernels(dev)
    tm, bank, _, launches = phase_slice(dev)
    phase_plain_bank(tm, bank)
    phase_small_reference(tm, bank)

    kernels = [dict(
        name="attention",
        route="cuda",
        source="hgr_tpu_torch/csrc/attention.cu",
        replaces="hgr_tpu/ops/attention.py:28",
        launches=launches,
        **main_row,
    )]
    log(json.dumps({"kernels": kernels}))
    log(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
