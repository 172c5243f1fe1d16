#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hgr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: require CUDA; print the card's name and power limit, whether
   the system's ``libzstd.so.1`` loads (the Orbax reader's one library) and
   its version, and whether g++ is on the path;
2. build: compile every kernel under ``hgr_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print the build time;
3. kernels against their plain versions on the card, at the main path's
   shapes and the edges of K1's contract (``KERNEL_CASES``: T from 1 to
   577, the tiled bf16 kernel's 64-row tile edges from T = 97, causal,
   unmasked and band masks), each with q/k/v as strided views of the
   packed projection and as contiguous tensors, with the stated tolerances; times of kernel, plain version and the
   library yardstick (``scaled_dot_product_attention``, never called by the
   port), and each case's bound;
3b. K2 (``ops/bn_act.py``, the ResNet's fused BatchNorm epilogue) against
   its plain twins on the card, in bf16 and fp32. Its backward first
   (``BN_ACT_BACKWARD_CASES``: RN50's train epilogues at batch 256, every
   variant at odd sizes): dx and dres equal to autograd of
   ``batch_norm_act``, the parameter gradients within ``BN_ACT_GRAD_TOL``
   of autograd's and of ``batch_norm_act_backward``'s, the batch-256 cases
   timed against their bytes and against autograd of the plain sequence.
   Then its forward, bit for bit (``BN_ACT_CASES``: RN50's epilogue shapes
   at batch 512, RN50x4's widths, every variant at odd sizes; some inputs
   -0.0); the cases of ``TIMED_BN_ACT`` timed by CUDA-graph replay against
   their bytes at 3.35 TB/s, beside the twin's time; then ``encode_image``
   of RN50 (bf16 and fp32, batch 512) and RN50x4 (bf16, batch 64) with
   seeded BatchNorm statistics: ``rn_epilogues`` K2 launches an encode (54
   and 84), the features equal to the twin path's, and the tower's time on
   each path; and RN50's tower forward and backward under autograd at batch
   256: 54 forward and 54 backward launches, the features equal to the
   plain epilogues' bit for bit, the gradients close, peak memory no
   higher. Every later phase that counts K1's launches on an RN path counts
   K2's beside them and asserts ``rn_epilogues`` an encoded batch (each
   mesh rank's half batch too; one encode a step inside CoOp's, whose CLIP
   is frozen), and ``rn_epilogues`` forward and backward launches a step
   inside OM, accumulated, flat and SPMD train steps (its autograd
   Function); the kernel table's K2 rows hold those counts by path;
3c. K3 (``ops/ln_act.py``, the transformer block's residual add +
   LayerNorm and its QuickGELU) against the plain twins on the card, in
   bf16 and fp32 (``LN_ACT_CASES``, ``GELU_CASES``: the ViT-L/14, ViT-B/16
   and bank shapes, ``ln_post``'s strided class-token rows, every width
   class at odd row counts): ``s`` bit for bit, ``y`` within one bf16 ulp
   of the larger of ``|y|`` and the bias (fp32: ``TOL``), QuickGELU bit for
   bit on every bf16 value and within one ulp at the shapes; the cases of
   ``TIMED_LN`` and ``TIMED_GELU`` timed by CUDA-graph replay
   against their bytes at 3.35 TB/s, beside the plain sequence; each
   wrapper's host time a call. Every later phase that counts K1 on a bank
   build or a ViT image batch counts K3 beside it where this script asserts
   its count (``ln_act_launches``: 2L + 1 add_layer_norm and L quick_gelu
   a text encode, 2L + 2 and L a ViT image encode, 3L + 1 and 0 an EVA-02
   image encode with L glu_layer_norm, the gate, which is 0 on every other
   path; 0 inside OM, CoOp and flat train steps, whose towers run under
   autograd); ViT-B/16's and
   ViT-L/14's features through K3 are held to the plain blocks'
   (``phase_ln_features``);
4. the ancestor chains of the smoke's hierarchy, held to the JAX package's
   with networkx by their digest (``EXPECTED_CHAINS_SHA256``);
5. zero-shot eval at full width: RN50, the 18,278-class bank padded to
   18,432, ``run_test`` over 4 batches of 512 synthetic images; K1's launch
   count over that run must be 12 layers x 36 chunks = 432;
6. the class bank rebuilt with the plain attention, held to the kernel's;
6b. the same bank in float32 (the parity mode) through K1's fp32 kernel:
   432 launches at (512, 8, 32, 64) causal, timed (cold and warm) beside the
   bank built with the plain attention, to which it is held within phase
   3's fp32 tolerance;
7. the card against the port's CPU path (the one the CPU tests hold to the
   JAX package) on a small input, in float32;
8. ViT-B/32 eval at full width against the same bank: ``run_test`` over 2
   batches of 512, where K1 also runs the image tower (T = 50, no mask, 12
   layers), so 432 + 12 x 2 = 456 launches; one batch's features through K1
   held to the plain attention's; ViT-B/16 the same way over one batch (T =
   197 in the image tower: 432 + 12 = 444 launches); then RN50x4 (288 px,
   its bank at 10 heads: 432 launches) over one batch;
8b. ViT-L/14 at full width through the user's route: an OpenAI-layout fp16
   ``.pt`` with seeded weights (428 M parameters), ``load_torch`` and
   ``run_test`` over one batch of 512 (432 + 24 launches at T = 257); one
   batch's features through K1 held to the plain attention's; then
   EVA02-CLIP-L/14 with seeded weights the same way (``phase_eva02_l14``:
   432 + 24 K1 launches, K3 900 + 73 and no QuickGELU, K3's SwiGLU gate 24,
   the rotary 24), its features through K1 and through K3 held to the plain
   attention's and blocks', an encode under autograd launching neither K3
   nor the rotary; before it K3's gate against its twin (``GLU_CASES``:
   bf16 within one ulp of max(|y|, |b|), fp32 within ``TOL``, the pad
   columns +0.0; ``GLU_MAIN`` timed against its bytes at 3.35 TB/s beside
   the twin) and the rotary against its twin (``ROTARY_CASES``: within one
   ulp; ``ROTARY_MAIN`` held to the float64 turn and timed against its bytes
   beside the twin and the three-pass sequence it replaced);
9. real inputs at RN50 width: the hierarchy as ``graph_edges_cls.json``,
   the splits, 18,278 word-like names, a BPE merges table learned from the
   prompts, an OpenAI-layout ``.pt`` and a decode cache of 2,048 seeded
   rows at 224 px (seeded colour grids under noise, which random weights
   tell apart), all written to a temporary directory; then
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
10b. decode processes: 512 seeded JPEGs of about 500 x 375 over 4 test and
    4 seen classes, decoded by 8 threads and by min(8, cores) processes
    (rows byte-equal, each timed, worker CPU per image), then ``run_test``
    from the files with ``--num_proc_workers``;
10c. the baselines' image path: ``python -m hgr_tpu_torch.baselines.run
    --baseline gcn --cnn <seeded torchvision ResNet-50 .pth>
    --refit_backbone`` over phase 9's hierarchy and the JPEGs (8 refit
    steps of 64, decode processes): metrics finite, the backbone moved;
    then ``--cnn`` in this process against ``--feature_file`` of
    ``tools/export_torch_image_feats.py`` with the same GCN: equal counts;
    the ResNet-50's features and one refit step in fp32, card against CPU;
    ``tools/export_torch_text_feats.py`` at RN50x4's text width (432
    launches);
11. OM training at full width: ``driver.run_train`` on RN50 in bf16 with
    remat, batch 256, 256 negatives, 4 episodes, then ``run_test`` over 2
    batches; every loss finite, the CLIP weights and ``layer_weight`` moved,
    no K1 launch inside a train step (autograd runs the plain attention), 54
    K2 forward and 54 backward launches a step (its autograd Function), and
    432 K1 and 2 x 54 K2 launches in the test after it, and ``clip_0``
    restores into a fresh
    train state; prints the steps' median time, images/s, the prompts
    encoded per step and peak memory;
11b. ``--trace_dir``: two OM steps write one Chrome trace naming CUDA
    kernels;
11c. OM training under gradient accumulation (``accum_steps=2``): RN50 in
    bf16 with remat, batch 1,024 as 2 microbatches of 512, 256 negatives,
    2 updates; no parameter moves after a first microbatch, the watched
    ones and ``layer_weight`` after the second, no K1 or K3 launch, 54 K2
    forward and 54 backward launches a microbatch;
    prints the update's time and peak memory;
12. one OM train step in float32 on the card against the port's CPU path
    (small TEST-ViT and TEST-RN configs, the same weights and schedule; on
    TEST-RN, K2's forward and backward 18 launches each): the loss and the
    updated weights agree within the CPU tests' tolerances;
13. K1's, K2's and K3's guards: a CUDA call that autograd would record
    raises; K2's autograd Function takes it (one forward and one backward
    launch, the gradient the twin's);
14. CoOp OM training at full width (RN50, bf16, remat, ``--coop_train
    ctx``, prompts of T = 48): 4 steps at batch 256 through
    ``driver.run_train``, every CLIP tensor bitwise unchanged, the context
    moved and saved in ``clip_0``, K1 0 times inside the steps and 432 in
    the test after them (the CoOp bank), which is then held to the bank
    built with the plain attention;
15. flat fine-tuning at full width (RN50, bf16, 1,000 seen classes): 4
    steps at batch 256 through ``driver.run_train_flat``, then the test
    (K1 0 times in the steps, 432 in the test);
16. the baselines runner over phase 9's hierarchy and splits (GCN as a
    ``python -m hgr_tpu_torch.baselines.run`` subprocess, CNZSL, FREE and,
    since PR 7, CLIP-flat by its ``main`` in this process;
    ``BASELINE_RUNS``: GCN dense_att, CNZSL and FREE at 512-d embeddings and 2,048-d features, CLIP-flat at TEST-RN, whose
    bank reaches K1 at head dim 16, 2 layers x 36 chunks = 72 launches):
    every metric of the final line finite;
17. one float32 step each of the CoOp OM loss, the flat step, CNZSL, GCN
    and FREE on the card against the port's CPU path, with the same
    weights, inputs and draws.

The mesh over ``torch.distributed`` (one card, so several ranks share it
over gloo; NCCL refuses two ranks on one GPU), and the offline builders:

The JAX package's Orbax checkpoints (``phase_orbax``, after a), from the
committed fixtures of ``tests/torch_fixtures/make_orbax_fixtures.py``:

o. the RN50 ``clip_0`` (with optax's state at step 7) read and timed (MB/s
   beside the card's name and power limit), every leaf of it and of the
   ResNet-50 ``_refit`` held to JAX's digests; ``python -m hgr_tpu_torch
   --load True --load_path <fixture>`` over one batch of phase 9's decode
   cache in a process of its own (432 K1 launches); the fp32 image, text
   and ResNet-50 (``--cnn``) features of seeded inputs, TF32 off, within
   ``ORBAX_FEAT_RTOL`` of JAX's CPU features; ``--resume`` from the fixture
   for one OM step at batch 256 through ``driver.run_train``: the loss
   finite, the step going on from 7, the update AdamW's on the carried
   moments, and its norm's ratio to a fresh AdamW step's printed.

a. (after phase 10) phase 9's CLI eval as 4 ranks under ``python -m
   torch.distributed.run`` with ``--mesh_data 2 --mesh_model 2
   --dist_backend gloo``, in a folder of its own with ``--load_path`` at
   phase 9's ``clip_0``: one final record; each image's merged top-20 test
   logits within ``MESH_VAL_ATOL`` of one process's and its predictions
   equal (or tied within it); the counts phase 9's; 432 K1 launches on
   each rank;
b. (after phase 17) the sharded merge on 4 gloo ranks, meshes (1, 4) and
   (2, 2), from exact slices of seeded full-logit matrices at the real
   geometry (ties everywhere, a level sunk below FILL): bitwise the
   one-device metrics;
c. (after phase 7) NCCL at world size 1: a 1 x 1 mesh whose collectives run
   through NCCL, the sharded step equal to ``eval_step_sorted``;
d. (after b) SPMD OM training on 4 gloo ranks, mesh (2, 2), RN50 bf16 with
   remat, batch 256 a replica, 256 negatives, 2 steps: parameters bitwise
   equal on every rank after each step, step 1's loss and gradient (cosine
   and norm) against one process's mean over the two replicas, the
   gradient all-reduce timed on each rank; then ``python -m
   hgr_tpu_torch --train True`` with the mesh under
   ``torch.distributed.run`` for one step;
e. ``python -m hgr_tpu_torch.hierarchy.builder`` on a seeded structure
   XML: the JAX builder's edges (``EXPECTED_BUILDER_SHA256``).

The second-to-last lines are the kernel table (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
# dense tensor-core bf16; for fp32, the dense TF32 rate over three: K1's
# fp32 kernel keeps fp32's accuracy on the tensor cores with three TF32
# products for each (3xTF32), so 165 TFLOP/s is the least time of its work
# (67 TFLOP/s, fp32 outside the tensor cores, no longer bounds it)
PEAK_FLOPS = {torch.bfloat16: 989e12,
              torch.float32: 495e12 / 3}
LEVEL_SIZES = [10, 800, 4000, 5000, 4000, 2500, 1000, 500, 250, 120, 60, 30, 8]
# phase 3's (shape, mask settings[, dtypes]); a mask setting is True (causal),
# False (none) or "band" (BAND_MASK): the bank build's T = 32, CLIP's full
# context 77 and a short prompt 20; ViT-B/32's 50 and ViT-B/16's 197 (12
# heads) without mask; T = 48 and 96, the last lengths of the three- and
# six-row-tile instantiations, so that every instantiation of the short bf16
# kernel is held to the plain version; T = 256 and T = 1; the TEST
# configurations' head dim 16 (padded to 64 in bf16, unpadded in fp32), which the
# baselines runner's CLIP-flat bank reaches at TEST-RN; ViT-L/14's 257 and
# ViT-L/14@336's 577 tokens (16 heads, no mask) and a causal T = 300;
# RN50x4's bank (10 heads); one launch of ViT-B/16's eval step (12 heads,
# T = 197) and, in bf16 only, of ViT-L/14's (a batch of 512 through each of
# its 24 layers), which read K1's share of those steps; and the edges of
# the tiled bf16 kernel (T >= 97): its first T, the 64-row tile edges 128,
# 129, 192, 193, 320 and 321, a single head (one block, no neighbours) and a
# band mask, whose 64-key blocks are dead or mixed; and bf16 at head dim 72
# (SigLIP So400m's, the tiled kernel at every T, no mask): short T and the
# tile edges, and a slice of each tower's launch (64 images at T =
# 729; a bank chunk's 512 prompts at T = 64), which phase_siglip_so400m
# times at full size
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
    ((512, 2, 32, 16), (True,)),
    ((64, 16, 257, 64), (False,)),
    ((16, 16, 577, 64), (False,)),
    ((8, 8, 300, 64), (True,)),
    ((512, 10, 32, 64), (True,)),
    ((512, 16, 257, 64), (False,), (torch.bfloat16,)),
    ((512, 12, 197, 64), (False,)),
    *(((8, 8, t, 64), (True, False), (torch.bfloat16,)) for t in (97, 128, 129, 192, 193, 320, 321)),
    ((1, 1, 257, 64), (True, False), (torch.bfloat16,)),
    ((8, 8, 300, 64), ("band",), (torch.bfloat16,)),
    *(((8, 8, t, 72), (False,), (torch.bfloat16,))
      for t in (1, 20, 32, 63, 64, 65, 97, 128, 129, 257, 321)),
    ((1, 1, 729, 72), (False,), (torch.bfloat16,)),
    ((64, 16, 729, 72), (False,), (torch.bfloat16,)),
    ((512, 16, 64, 72), (False,), (torch.bfloat16,)),
]
# the band mask's half-width and its seed: -inf outside |row - key| <= 80,
# seeded values in [-2, 2) inside
BAND_MASK = dict(width=80, seed=5)
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


@contextlib.contextmanager
def plain_attention():
    """The towers' fused blocks with the plain ``attention_scores`` in K1's
    place, to hold K1's path to the plain attention: the one name
    ``models/transformer.py`` and ``models/eva_vit.py`` call there,
    substituted. Asserts that K1 did not launch inside; K1's count outside
    goes on as if the block were not there."""
    from hgr_tpu_torch.models import eva_vit, transformer
    from hgr_tpu_torch.models.layers import attention_scores
    from hgr_tpu_torch.ops.attention import attention

    saved, attention.launches = attention.launches, 0
    try:
        with mock.patch.object(transformer, "attention", attention_scores), \
                mock.patch.object(eva_vit, "attention", attention_scores):
            yield
        assert attention.launches == 0, f"K1 ran {attention.launches} times on the plain path"
    finally:
        attention.launches += saved


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


def smi_clock_power() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
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
    from hgr_tpu_torch.ops import attention, bn_act, build, ln_act

    t0 = time.time()
    logs = build.build(build.all_sources())
    attention._library()
    bn_act._library()
    ln_act._library()
    log(f"[build] {build.all_sources()} in {time.time() - t0:.1f} s -> {build.BUILD_DIR}")
    for line in "\n".join(logs).splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Function properties")):
            log(f"[build] {line.strip()}")
    sass_tensor_ops(build)


def sass_tensor_ops(build):
    """K1's fp32 kernels must run their products on the tensor cores: count
    the HMMA instructions (and those on TF32) in each instantiation of
    ``attention_fwd_f32_one<Dh, groups>`` (T <= 64) and
    ``attention_fwd_f32_multi<Dh, mask>`` in ``cuobjdump -sass`` of the
    built library."""
    import os
    import re

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path("attention"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    seen = 0
    for part in sass.split("Function : ")[1:]:
        inst = re.search(r"(attention_fwd_f32_\w+?)ILi(\d+)E(?:L[ib](\d+)E)?", part.split("\n", 1)[0])
        if inst is None:
            continue
        name = f"{inst[1]}<{', '.join(a for a in inst.groups()[1:] if a)}>"
        lines = part.splitlines()
        hmma = sum("HMMA" in line for line in lines)
        tf32 = sum("HMMA" in line and "TF32" in line for line in lines)
        local = sum(re.search(r"\b(LDL|STL)\b", line) is not None for line in lines)
        log(f"[build] sass {name}: {hmma} HMMA, {tf32} of them TF32; {local} local-memory "
            f"loads and stores")
        assert tf32 > 0, f"{name} has no TF32 tensor-core instruction"
        seen += 1
    assert seen == 14, f"{seen} instantiations of attention_fwd_f32 in the SASS, not 14"


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


def band_mask(T, dev, width, seed):
    """An additive [T, T] mask that is neither causal nor zero: -inf outside
    the band |row - key| <= width, seeded values in [-2, 2) inside it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.rand((T, T), generator=g, device=dev) * 4 - 2
    i = torch.arange(T, device=dev)
    return torch.where((i[:, None] - i[None, :]).abs() <= width, vals, float("-inf"))


def phase_kernels(dev):
    """K1 against attention_scores on the card, with times and bounds."""
    import torch.nn.functional as F

    from hgr_tpu_torch.models.layers import attention_scores, causal_mask
    from hgr_tpu_torch.ops.attention import attention

    g = torch.Generator(device=dev).manual_seed(0)
    main = None
    for shape, masks, *dtypes in KERNEL_CASES:
        for dtype in (dtypes[0] if dtypes else (torch.bfloat16, torch.float32)):
            for layout in ("packed", "contiguous"):
                q, k, v = qkv_views(shape, dtype, layout, g, dev)
                for kind in masks:
                    T = shape[2]
                    mask = (band_mask(T, dev, **BAND_MASK) if kind == "band"
                            else causal_mask(T, device=dev) if kind else None)
                    row = check_attention(attention, attention_scores, F.scaled_dot_product_attention,
                                          q, k, v, mask, causal=kind is True)
                    name = str(dtype).split(".")[-1]
                    eager = row.pop("eager_ms")
                    log(f"[kernel] attention {shape} {name} {layout} mask={kind}: max_abs_err "
                        f"{row['max_abs_err']:.3e} (tol {TOL[dtype][0]:g} + {TOL[dtype][1]:g}|p|) ok | "
                        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
                        f"| {row['bound_ms'] / row['ms']:.1%} of bound | kernel eager "
                        f"{eager:.4f} ms a call, host included")
                    if shape == MAIN_SHAPE and dtype == torch.bfloat16 and layout == "packed" and kind is True:
                        main = row
    return main


def check_attention(kernel, plain, sdpa, q, k, v, mask, causal):
    """One case of phase 3: the kernel held to its plain version (raises
    beyond TOL), then the three timed on the device; returns the
    kernel-table fields and ``eager_ms``, the kernel's time a call from
    Python, host included. SDPA gets ``is_causal`` for a causal mask and the
    mask itself for any other."""
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
    bound, by = attention_bound_ms(tuple(q.shape), q.dtype, mask)
    library = (dict(is_causal=True) if causal else {} if mask is None
               else dict(attn_mask=mask.to(q.dtype)))
    return dict(
        ms=graph_ms(lambda: kernel(q, k, v, mask)),
        plain_ms=graph_ms(lambda: plain(q, k, v, mask)),
        library_ms=graph_ms(lambda: sdpa(q, k, v, **library)),
        bound_ms=bound, bound_by=by, max_abs_err=err,
        eager_ms=cuda_ms(lambda: kernel(q, k, v, mask)),
    )


def rn_epilogues(clip_cfg) -> int:
    """K2's launches a modified-ResNet encode: the stem's 3, 3 a bottleneck
    (the last with its downsample's BatchNorm folded in), and the 2x2 pool
    of the input of layers 2-4's strided first blocks; 0 for a ViT."""
    if clip_cfg.is_vit:
        return 0
    return 3 + 3 * sum(clip_cfg.vision_layers) + 3


def rn_epilogues_of(arch: str) -> int:
    """``rn_epilogues`` of a zoo architecture."""
    from hgr_tpu_torch.models.clip import get_config

    return rn_epilogues(get_config(arch))


class SeededBN:
    """BatchNorm parameters as ``models.layers.BatchNorm2d`` holds them,
    drawn from ``g``: a fold that is not the identity."""

    def __init__(self, C, g, dev):
        def draw(scale, shift):
            return torch.randn(C, generator=g, device=dev) * scale + shift

        self.weight, self.bias, self.running_mean = draw(0.5, 1.0), draw(0.5, 0), draw(0.5, 0)
        self.running_var = torch.rand(C, generator=g, device=dev) * 2 + 0.05


# phase 3b's K2 cases, (N, C, H, W) and the variants at that shape; a variant
# is (fold, residual, relu, pool) with residual None, "plain" or "folded"
# (the downsample's BatchNorm folded in). RN50's epilogues at batch 512 (the
# stem's two and its pooled third, layer1's bn1 and bn3 with either
# residual, a strided block's pooled bn2 and its downsample's pool, layer4's)
# and RN50x4's widths at batch 64 (288 px: channels 40 to 2,560, not powers
# of two); then every variant (the pool takes no residual) at an odd
# [3, 80, 9, 11] and a [2, 8, 5, 4] (one vector a pixel), where the pool
# drops an odd last row or column.
# Variants marked by TIMED_BN_ACT are timed.
RELU, POOL_RELU = (True, None, True, False), (True, None, True, True)
BN_ACT_CASES = [
    ((512, 32, 112, 112), (RELU,)),
    ((512, 64, 112, 112), (POOL_RELU,)),
    ((512, 64, 56, 56), (RELU,)),
    ((512, 256, 56, 56), ((True, "plain", True, False), (True, "folded", True, False),
                          (False, None, False, True))),
    ((512, 128, 56, 56), (POOL_RELU,)),
    ((512, 512, 14, 14), (POOL_RELU,)),
    ((512, 512, 7, 7), (RELU,)),
    ((512, 2048, 7, 7), ((True, "plain", True, False), (True, "folded", True, False))),
    ((64, 40, 144, 144), (RELU,)),
    ((64, 80, 144, 144), (POOL_RELU,)),
    ((64, 320, 72, 72), ((True, "plain", True, False), (True, "folded", True, False),
                         (False, None, False, True))),
    ((64, 640, 18, 18), (POOL_RELU,)),
    ((64, 2560, 9, 9), ((True, "plain", True, False),)),
    *(((n, c, h, w), tuple((fold, res, relu, pool) for fold in (False, True)
                           for res in (None, "plain", "folded") for relu in (False, True)
                           for pool in (False, True) if not (res and pool)))
      for n, c, h, w in ((3, 80, 9, 11), (2, 8, 5, 4))),
]
TIMED_BN_ACT = {
    ((512, 256, 56, 56), (True, "plain", True, False)),   # layer1's bn3: the main shape
    ((512, 256, 56, 56), (True, "folded", True, False)),  # layer1.0's bn3 with its downsample
    ((512, 64, 56, 56), RELU),                            # layer1's bn1
    ((512, 64, 112, 112), POOL_RELU),                     # the stem's bn3 and pool
    ((512, 256, 56, 56), (False, None, False, True)),     # layer2.0's downsample pool
    ((512, 2048, 7, 7), (True, "plain", True, False)),    # layer4's bn3
    ((512, 512, 14, 14), POOL_RELU),                      # layer4.0's bn2 and pool
}
BN_ACT_MAIN = ((512, 256, 56, 56), (True, "plain", True, False))


def bn_act_bytes(shape, dtype, residual, pool) -> int:
    """Bytes K2 must move: the input (and residual) read once, the output
    written once (a quarter of it pooled); the [C] parameters are noise."""
    N, C, H, W = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    n_in = N * C * H * W
    n_out = N * C * (H // 2) * (W // 2) if pool else n_in
    return (n_in * (2 if residual else 1) + n_out) * elem


# phase 3b's encodes: (arch, batch, dtypes)
BN_ACT_ENCODES = (("RN50", 512, (torch.bfloat16, torch.float32)),
                  ("RN50x4", 64, (torch.bfloat16,)))

# phase 3b's backward cases: RN50's epilogues in the train step at batch 256
# (layer1's bn3 with either residual and its bn1, the stem's pooled bn3, a
# strided block's pooled bn2, layer2.0's downsample pool, layer4's bn3), all
# timed; then every variant at the odd sizes of BN_ACT_CASES
BN_ACT_BACKWARD_CASES = [
    ((256, 256, 56, 56), ((True, "plain", True, False), (True, "folded", True, False),
                          (False, None, False, True))),
    ((256, 64, 56, 56), (RELU,)),
    ((256, 64, 112, 112), (POOL_RELU,)),
    ((256, 128, 56, 56), (POOL_RELU,)),
    ((256, 2048, 7, 7), ((True, "plain", True, False),)),
    *BN_ACT_CASES[-2:],
]
BN_ACT_BACKWARD_MAIN = ((256, 256, 56, 56), (True, "plain", True, False))
# the backward's parameter gradients (fp32 [C] each, over N*H*W terms) against
# the backward twin on the card (the same g_m, fp32 sums in another order) and
# against autograd of the forward twin, which in bf16 also rounds each product
# g*x to bf16 before summing and the sums of g and g*x to bf16 (2^-9 relative
# each): the largest gap over the tensor's largest magnitude
BN_ACT_GRAD_TOL = {"twin": 1e-4, torch.float32: 1e-4, torch.bfloat16: 3e-2}


def bn_act_backward_bytes(shape, dtype, fold, residual, relu, pool) -> int:
    """Bytes K2's backward must move: g (the output's size) read once, x
    read where relu's mask or the fold's sum needs it, the residual where
    the mask or its own fold's sum does, dx (and dres) written once; the
    [C] sums are noise. The pool-only epilogue reads g alone."""
    N, C, H, W = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    n_in = N * C * H * W
    n_out = N * C * (H // 2) * (W // 2) if pool else n_in
    reads = (relu or fold) + (bool(residual) and (relu or residual == "folded"))
    return (n_out + n_in * (reads + 1 + bool(residual))) * elem


def _rel_gap(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_bn_act_backward(dev, g, shape, dtype, variants, timed):
    """K2's backward at one shape and dtype, each variant against autograd of
    the forward twin (dx and dres equal; the parameter gradients within
    ``BN_ACT_GRAD_TOL``) and against the backward twin. Logs a line each;
    returns the kernel-table row of the timed variants, keyed by variant."""
    from hgr_tpu_torch.models.layers import batch_norm_act, batch_norm_act_backward
    from hgr_tpu_torch.ops.bn_act import bn_act_backward

    N, C, H, W = shape

    def nhwc(h=H, w=W):
        t = torch.randn((N, h, w, C), generator=g, device=dev).mul_(2).to(dtype)
        t.view(-1)[::97] = -0.0
        return t.permute(0, 3, 1, 2)

    x, res = nhwc(), nhwc()
    bn, rbn = SeededBN(C, g, dev), SeededBN(C, g, dev)
    rows, name = {}, str(dtype).split(".")[-1]
    for fold, residual, relu, pool in variants:
        b, r = bn if fold else None, res if residual else None
        rb = rbn if residual == "folded" else None
        leaves = [x.detach().requires_grad_(True)] + (
            [res.detach().requires_grad_(True)] if r is not None else [])
        trained = [None if m is None else SimpleNamespace(**{
            k: getattr(m, k).detach().requires_grad_(True)
            for k in ("weight", "bias", "running_mean", "running_var")}) for m in (b, rb)]
        for m in trained:
            if m is not None:
                leaves += [m.weight, m.bias, m.running_mean, m.running_var]
        out = batch_norm_act(leaves[0], trained[0], leaves[1] if r is not None else None,
                             trained[1], relu, pool)
        grad = nhwc(*out.shape[2:]) if pool else nhwc()
        want = torch.autograd.grad(out, leaves, grad, retain_graph=True)
        dx, dres, bn_grads, rbn_grads = bn_act_backward(grad, x, b, r, rb, relu, pool)
        got = [dx] + ([dres] if r is not None else []) + (bn_grads or []) + (rbn_grads or [])
        with torch.no_grad():
            tw = batch_norm_act_backward(grad, x, b, r, rb, relu, pool)
        twin = [tw[0]] + ([tw[1]] if r is not None else []) + (tw[2] or []) + (tw[3] or [])
        torch.cuda.synchronize()
        n_act = 1 + (r is not None)
        for i in range(n_act):
            assert dev.type != "cuda" or got[i].is_contiguous(
                memory_format=torch.channels_last), got[i].stride()
            if not (torch.equal(got[i], want[i]) and torch.equal(got[i], twin[i])):
                raise AssertionError(
                    f"K2's backward differs from autograd of its twin at {shape} {name} "
                    f"fold={fold} residual={residual} relu={relu} pool={pool}, "
                    f"{('dx', 'dres')[i]}: max |diff| "
                    f"{float((got[i].float() - want[i].float()).abs().max()):.3e}")
        gap_twin = max((_rel_gap(a, t) for a, t in zip(got[n_act:], twin[n_act:])), default=0.0)
        gap = max((_rel_gap(a, w) for a, w in zip(got[n_act:], want[n_act:])), default=0.0)
        variant = (fold, residual, relu, pool)
        line = (f"[k2-bwd] bn_act backward {shape} {name} fold={fold} residual={residual} "
                f"relu={relu} pool={pool}: dx{', dres' if r is not None else ''} equal to "
                f"autograd's; parameter gradients' largest gap {gap:.2e} to autograd's (tol "
                f"{BN_ACT_GRAD_TOL[dtype]:g}), {gap_twin:.2e} to the backward twin's (tol "
                f"{BN_ACT_GRAD_TOL['twin']:g})")
        assert gap <= BN_ACT_GRAD_TOL[dtype] and gap_twin <= BN_ACT_GRAD_TOL["twin"], line
        if timed:
            nbytes = bn_act_backward_bytes(shape, dtype, fold, residual, relu, pool)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(ms=graph_ms(lambda: bn_act_backward(grad, x, b, r, rb, relu, pool)),
                       eager_ms=cuda_ms(lambda: bn_act_backward(grad, x, b, r, rb, relu, pool)),
                       plain_ms=cuda_ms(lambda: torch.autograd.grad(out, leaves, grad,
                                                                   retain_graph=True)),
                       bound_ms=bound, bound_by="bytes", max_rel_err=gap)
            line += (f" | kernel {row['ms']:.4f} ms (two launches, graph replay), eager "
                     f"{row['eager_ms']:.4f} ms a call with the host's; autograd of the plain "
                     f"sequence {row['plain_ms']:.4f} ms eager | bound {bound:.4f} ms "
                     f"({nbytes / 1e9:.3f} GB), {bound / row['ms']:.1%} of 3.35 TB/s")
            rows[variant] = row
        log(line)
        del out, want, got, twin, leaves, grad
    return rows


def check_encode_under_autograd(dev, m, images, dtype=torch.bfloat16):
    """The image tower's forward and backward as the train step runs them
    (every tensor of ``m.visual`` trained), through K2's Function and
    through the plain epilogues (``bn_act_autograd`` patched to the twin):
    the features equal bit for bit, 54 forward and 54 backward K2 launches
    for RN50, each gradient within 3e-2 of the plain path's in norm (cuDNN's
    weight gradients may sum in another order; autograd rounds the
    BatchNorm sums to bf16), peak memory no higher, and both paths' times.
    Returns the K2 path's (forward, backward) launches as its counters read
    them."""
    from hgr_tpu_torch.models import clip, resnet
    from hgr_tpu_torch.models.layers import batch_norm_act
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward

    trained = dict(m.visual.state_dict(keep_vars=True))
    for t in trained.values():
        t.requires_grad_(True)
    proj = torch.randn(images.shape[0], m.cfg.embed_dim, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5))

    def step():
        for t in trained.values():
            t.grad = None
        feats = clip.encode_image(m, images, dtype=dtype)
        (feats.float() * proj).sum().backward()
        return feats.detach()

    try:
        out = {}
        for path in ("k2", "plain"):
            with (mock.patch.object(resnet, "bn_act_autograd", batch_norm_act)
                  if path == "plain" else contextlib.nullcontext()):
                bn_act.launches = bn_act_backward.launches = 0
                _reset_peak(dev)
                feats = step()
                torch.cuda.synchronize()
                out[path] = dict(feats=feats, launches=(bn_act.launches, bn_act_backward.launches),
                                 peak=_peak_gib(dev), ms=cuda_ms(step, reps=3, warmup=1),
                                 grads={k: t.grad.clone() for k, t in trained.items()})
        gaps = {k: float((out["k2"]["grads"][k] - g).norm() / g.norm().clamp_min(1e-30))
                for k, g in out["plain"]["grads"].items()}
        worst = max(gaps, key=gaps.get)
        same = torch.equal(out["k2"]["feats"], out["plain"]["feats"])
        want = rn_epilogues(m.cfg)
        log(f"[k2-bwd] RN50 encode_image forward and backward under autograd, {dtype}, batch "
            f"{images.shape[0]}: K2 launches (forward, backward) {out['k2']['launches']} (want "
            f"{want} each; the plain path {out['plain']['launches']}); features equal to the "
            f"plain epilogues' bit for bit: {same}; {len(gaps)} gradients, largest norm gap "
            f"{gaps[worst]:.2e} ({worst}; tol 3e-2); tower forward + backward "
            f"{out['k2']['ms']:.2f} ms with K2, {out['plain']['ms']:.2f} ms plain; peak "
            f"{out['k2']['peak']:.2f} GiB with K2, {out['plain']['peak']:.2f} GiB plain")
        assert out["k2"]["launches"] == (want, want) and out["plain"]["launches"] == (0, 0)
        assert same, float((out["k2"]["feats"].float() - out["plain"]["feats"].float()).abs().max())
        assert gaps[worst] <= 3e-2, (worst, gaps[worst])
        assert out["k2"]["peak"] <= out["plain"]["peak"], (out["k2"]["peak"], out["plain"]["peak"])
        return out["k2"]["launches"]
    finally:
        for t in trained.values():
            t.requires_grad_(False)
            t.grad = None


def phase_bn_act(dev, cases=BN_ACT_CASES, encodes=BN_ACT_ENCODES):
    """K2 against its plain twins on the card: first its backward at every
    case of ``BN_ACT_BACKWARD_CASES`` in bf16 and fp32 (``check_bn_act_backward``;
    the batch-256 cases timed against their bytes and autograd of the plain
    sequence); then its forward at every case of ``BN_ACT_CASES`` in bf16 and
    fp32, bit for bit (the inputs hold some -0.0), the timed cases against
    their bytes at 3.35 TB/s with the twin's time as ``library_ms``; then
    the launches of an RN50 and an RN50x4 encode and their features, held
    equal to the twin path's, and RN50's tower forward and backward under
    autograd at batch 256 (``check_encode_under_autograd``). Returns the
    kernel-table rows of the forward's and the backward's main shapes, the
    K2 launches each encode counted, keyed ``<arch>_encode_<dtype>`` (the
    autograd encode's forward as ``rn50_encode_train_bfloat16``), and the
    backward launches that encode counted, under the same key."""
    from unittest import mock

    from hgr_tpu_torch.models import clip, resnet
    from hgr_tpu_torch.models.layers import batch_norm_act
    from hgr_tpu_torch.ops.bn_act import bn_act

    g = torch.Generator(device=dev).manual_seed(3)
    main, counted, counted_backward = None, {}, {}
    for shape, variants in BN_ACT_BACKWARD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            rows = check_bn_act_backward(dev, g, shape, dtype, variants, timed=shape[0] == 256)
            if shape == BN_ACT_BACKWARD_MAIN[0] and dtype == torch.bfloat16:
                backward = rows[BN_ACT_BACKWARD_MAIN[1]]
        torch.cuda.empty_cache()
    for shape, variants in cases:
        N, C, H, W = shape
        for dtype in (torch.bfloat16, torch.float32):
            def nhwc():
                t = torch.randn((N, H, W, C), generator=g, device=dev).mul_(2).to(dtype)
                t.view(-1)[::97] = -0.0
                return t.permute(0, 3, 1, 2)

            x, res = nhwc(), nhwc()
            bn, rbn = SeededBN(C, g, dev), SeededBN(C, g, dev)
            for fold, residual, relu, pool in variants:
                args = (x, bn if fold else None, res if residual else None,
                        rbn if residual == "folded" else None, relu, pool)
                got, want = bn_act(*args), batch_norm_act(*args)
                torch.cuda.synchronize()
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                assert got.shape == want.shape and got.is_contiguous(
                    memory_format=torch.channels_last), (got.shape, want.shape, got.stride())
                differ = got.view(bits) != want.view(bits)
                if bool(differ.any()):
                    zeros = bool(((got == 0) & (want == 0))[differ].all())
                    raise AssertionError(
                        f"K2 differs from its twin at {shape} {dtype} fold={fold} "
                        f"residual={residual} relu={relu} pool={pool}: {int(differ.sum())} of "
                        f"{got.numel()} elements, max |diff| "
                        f"{float((got.float() - want.float()).abs().max()):.3e}, "
                        f"{'all' if zeros else 'not all'} signed zeros")
                name = str(dtype).split(".")[-1]
                variant = (fold, residual, relu, pool)
                line = (f"[k2] bn_act {shape} {name} fold={fold} residual={residual} relu={relu} "
                        f"pool={pool}: bit-identical to the twin")
                if (shape, variant) in TIMED_BN_ACT:
                    nbytes = bn_act_bytes(shape, dtype, residual, pool)
                    bound = nbytes / HBM_BYTES_PER_S * 1e3
                    row = dict(ms=graph_ms(lambda: bn_act(*args)),
                               plain_ms=graph_ms(lambda: batch_norm_act(*args)),
                               bound_ms=bound, bound_by="bytes",
                               eager_ms=cuda_ms(lambda: bn_act(*args)))
                    row["library_ms"] = row["plain_ms"]
                    line += (f" | kernel {row['ms']:.4f} ms, plain sequence {row['plain_ms']:.4f} "
                             f"ms, bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) | "
                             f"{bound / row['ms']:.1%} of 3.35 TB/s | kernel eager "
                             f"{row.pop('eager_ms'):.4f} ms a call, host included")
                    if (shape, variant) == BN_ACT_MAIN and dtype == torch.bfloat16:
                        main = dict(row, max_abs_err=0.0)
                log(line)
            del x, res
    torch.cuda.empty_cache()

    for arch, batch, dtypes in encodes:
        cfg = clip.get_config(arch)
        m = clip.clip_init(cfg, torch.Generator().manual_seed(0), dev).eval()
        for mod in m.visual.modules():  # frozen statistics that are not the identity
            if isinstance(mod, resnet.BatchNorm2d):
                seeded = SeededBN(mod.weight.shape[0], g, dev)
                for key in ("weight", "bias", "running_mean", "running_var"):
                    getattr(mod, key).data.copy_(getattr(seeded, key))
        res = cfg.image_resolution
        images = torch.randint(0, 256, (batch, res, res, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        for dtype in dtypes:
            with torch.inference_mode():
                bn_act.launches = 0
                feats = clip.encode_image(m, images, dtype=dtype)
                launches = bn_act.launches
                tower_ms = cuda_ms(lambda: clip.encode_image(m, images, dtype=dtype), reps=5)
                with mock.patch.object(resnet, "bn_act", batch_norm_act):
                    plain = clip.encode_image(m, images, dtype=dtype)
                    plain_ms = cuda_ms(lambda: clip.encode_image(m, images, dtype=dtype), reps=5)
            same = torch.equal(feats, plain)
            name = str(dtype).split(".")[-1]
            log(f"[k2] {arch} encode_image {name}, batch {batch}: {launches} K2 launches (want "
                f"{rn_epilogues(cfg)}); features equal to the plain epilogues' {same}; tower "
                f"{tower_ms:.2f} ms with K2, {plain_ms:.2f} ms with the plain epilogues")
            assert launches == rn_epilogues(cfg), launches
            assert same, float((feats.float() - plain.float()).abs().max())
            counted[f"{arch.lower()}_encode_{name}"] = launches
        if arch == "RN50":  # the train step's tower, at the train cell's batch
            counted["rn50_encode_train_bfloat16"], counted_backward[
                "rn50_encode_train_bfloat16"] = check_encode_under_autograd(dev, m, images[:256])
        del m
    torch.cuda.empty_cache()
    return main, backward, counted, counted_backward


def ln_act_launches(clip_cfg, bank_chunks=0, image_batches=0):
    """The transformer kernels' launches, K3's and the rotary's, in the order
    of ``K3_NAMES`` (add_layer_norm, quick_gelu, glu_layer_norm, rotary): a text
    encode (a bank chunk) 2L + 1, L and 0 (block 0's ln_1, each block's
    ln_2, the next block's ln_1 with the MLP's add, ln_final with the last
    one; no QuickGELU in a GELU text tower), a ViT image encode 2L + 2, L
    and 0 (ln_pre and ln_post beside the blocks'; the last block's add is a
    plain one), an EVA-02 image encode 3L + 1, 0 and L (block 0's norm1,
    each block's inner_attn_ln and norm2, the next block's norm1 with the
    MLP's add, the final norm with the last one, on the class token's rows;
    each block's SwiGLU gate with its ffn_ln) and L rotaries (each block's
    q and k), a SigLIP image encode 2L + 1, 0 and 0 (the blocks' as a text
    encode's, the last add in post_layernorm over all rows; the MAP head's
    LayerNorm is PyTorch's); nothing for a ResNet's image tower. The rotary
    is 0 on every path but an EVA-02 image encode."""
    lt = clip_cfg.transformer_layers
    gelu_t = lt if clip_cfg.text_activation == "quick_gelu" else 0
    li = clip_cfg.vision_layers[0] if clip_cfg.is_vit else 0
    images = image_batches if clip_cfg.is_vit else 0
    ln_i, gelu_i, glu_i, rot_i = {"eva02": (3 * li + 1, 0, li, li),
                                  "siglip": (2 * li + 1, 0, 0, 0)}.get(clip_cfg.vision_block,
                                                                       (2 * li + 2, li, 0, 0))
    return (bank_chunks * (2 * lt + 1) + images * ln_i, bank_chunks * gelu_t + images * gelu_i,
            images * glu_i, images * rot_i)


def bank_chunks(tm) -> int:
    """The text encodes of one bank build (``TreeModel.update_classifier``)."""
    return tm.n_pad // min(512, tm.n_pad)


# the transformer kernels whose launches the phases count together: K3's
# three and EVA-02's rotary (``ln_act_launches``, ``k3_launches``)
K3_NAMES = ("add_layer_norm", "quick_gelu", "glu_layer_norm", "rotary")
K3_NONE = (0,) * len(K3_NAMES)


def k3_launches():
    from hgr_tpu_torch.ops.ln_act import add_layer_norm, glu_layer_norm, quick_gelu
    from hgr_tpu_torch.ops.rope import rotary

    return add_layer_norm.launches, quick_gelu.launches, glu_layer_norm.launches, rotary.launches


def k3_reset():
    from hgr_tpu_torch.ops.ln_act import add_layer_norm, glu_layer_norm, quick_gelu
    from hgr_tpu_torch.ops.rope import rotary

    add_layer_norm.launches = quick_gelu.launches = glu_layer_norm.launches = 0
    rotary.launches = 0


class SeededLN:
    """LayerNorm parameters as ``models.layers.LayerNorm`` holds them,
    drawn from ``g``: not the identity."""

    def __init__(self, D, g, dev):
        self.weight = torch.randn(D, generator=g, device=dev) * 0.5 + 1.0
        self.bias = torch.randn(D, generator=g, device=dev) * 0.5
        self.eps = 1e-5


# phase 3c's add_layer_norm cases, (rows, width, with a delta, rows picked
# with a stride): ViT-L/14's blocks and ln_pre (512 x 257 tokens) and its
# ln_post (the class token's rows of [512, 257, 1024]), ViT-B/16's blocks
# (512 x 197), a bank chunk at T = 32 (RN50's and ViT-B's text width 512,
# RN50x4's 640) and ViT-L/14's text tower at 512 x 77, SigLIP So400m's
# blocks at 1,152 (512 x 729 tokens) and its bank chunk (512 x 64); then
# every width class (one to five 16-byte vectors a lane in bf16, up to ten
# in fp32, 1,152's ragged fifth, and a row of a single vector) at a single
# row and at 13 (a partial block), with and without a delta, contiguous and
# strided
LN_ACT_CASES = [
    (131584, 1024, True, False),
    (131584, 1024, False, False),
    (512, 1024, False, True),
    (100864, 768, True, False),
    (16384, 512, True, False),
    (16384, 640, True, False),
    (39424, 768, True, False),
    (373248, 1152, True, False),
    (32768, 1152, True, False),
    *((rows, width, delta, strided) for rows in (1, 13)
      for width in (8, 32, 64, 136, 1000, 1024, 1152, 1280)
      for delta in (False, True) for strided in (False, True)),
]
TIMED_LN = {(131584, 1024, True, False), (131584, 1024, False, False),
            (100864, 768, True, False), (16384, 512, True, False), (373248, 1152, True, False)}
LN_MAIN = (131584, 1024, True, False)
# QuickGELU on the c_fc output [tokens, 4 x width]: ViT-L/14's, ViT-B/16's, a
# bank chunk's; odd sizes (one vector, a ragged grid-stride tail)
GELU_CASES = [(131584, 4096), (100864, 3072), (16384, 2048), (1, 8), (3, 40), (7, 1000)]
TIMED_GELU = {(131584, 4096), (100864, 3072), (16384, 2048)}
GELU_MAIN = (131584, 4096)


def ulps_apart(a, b):
    """Elementwise distance in units in the last place between two tensors
    of one float dtype (+0.0 and -0.0 are 0 apart)."""
    bits, top = (torch.int16, 1 << 15) if a.dtype == torch.bfloat16 else (torch.int32, 1 << 31)
    ia, ib = (t.contiguous().view(bits).long() for t in (a, b))
    oa, ob = (torch.where(i < 0, -(i + top), i) for i in (ia, ib))
    return (oa - ob).abs()


def bf16_ulp(t):
    """The spacing of bf16 values at ``|t|`` (fp32): 2^(e - 8) for |t| in
    [2^(e-1), 2^e)."""
    exp = torch.frexp(t.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(t), exp - 8)


def host_us(fn, calls=2000):
    """Host microseconds a call of ``fn``, the device kept from becoming the
    limit by a tiny input: the wrapper's Python, checks and launch."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_ln_act(dev, ln_cases=LN_ACT_CASES, gelu_cases=GELU_CASES):
    """K3 against its plain twins on the card (``s`` bit for bit; ``y``
    within one bf16 ulp of the larger of the twin's ``|y|`` and the bias,
    since where ``w * n`` and ``b`` cancel to near 0 the order of the fp32
    sums shows as many ulps of a tiny ``y``; fp32's ``TOL``; QuickGELU bit
    for bit or within one ulp), the timed cases against their bytes at 3.35 TB/s beside the
    plain sequence, and each wrapper's host time a call beside the plain
    sequence's. Returns the kernel-table rows of the main shapes of
    add_layer_norm and quick_gelu."""
    from hgr_tpu_torch.models.layers import layer_norm, quick_gelu as gelu_twin
    from hgr_tpu_torch.ops.ln_act import add_layer_norm, quick_gelu

    g = torch.Generator(device=dev).manual_seed(5)
    rows_out = {}

    def plain_ln(x, d, ln):
        s = x if d is None else x + d
        return s, layer_norm(s, ln.weight, ln.bias)

    for case in ln_cases:
        rows, width, with_delta, strided = case
        for dtype in (torch.bfloat16, torch.float32):
            def draw(scale, shift):
                n = 3 if strided else 1
                t = (torch.randn((rows, n, width), generator=g, device=dev) * scale + shift)
                t.view(-1)[::89] = -0.0
                return t.to(dtype)[:, 1:2] if strided else t.to(dtype)[:, 0]

            x = draw(2.0, 0.5)
            d = draw(1.0, 0.0) if with_delta else None
            ln = SeededLN(width, g, dev)
            (s, y), (ws, wy) = add_layer_norm(x, d, ln), plain_ln(x, d, ln)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            if with_delta:
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                differ = int((s.view(bits) != ws.contiguous().view(bits)).sum())
                assert differ == 0, f"K3's sum differs from the twin's at {case} {name}: {differ}"
            u = ulps_apart(y, wy)
            diff = (y.float() - wy.float()).abs()
            err = float(diff.max())
            if dtype == torch.bfloat16:
                scale = torch.maximum(wy.float().abs(), ln.bias.abs())
                ok, tol = bool((diff <= bf16_ulp(scale)).all()), "1 ulp of max(|y|, |b|)"
            else:
                atol, rtol = TOL[dtype]
                ok, tol = bool(((y - wy).abs() <= atol + rtol * wy.abs()).all()), \
                    f"{atol:g} + {rtol:g}|p|"
            line = (f"[k3] add_layer_norm [{rows}, {width}] {name} delta={with_delta} "
                    f"strided={strided}: s bit for bit; y max {int(u.max())} ulps ("
                    f"{int((u > 1).sum())} over 1), {int((u > 0).sum())} of {y.numel()} differ, "
                    f"max |diff| {err:.3e} (tol {tol})")
            assert ok, line
            if case in TIMED_LN and dtype == torch.bfloat16:
                nbytes = rows * width * x.element_size() * (4 if with_delta else 2)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                row = dict(ms=graph_ms(lambda: add_layer_norm(x, d, ln)),
                           plain_ms=graph_ms(lambda: plain_ln(x, d, ln)),
                           bound_ms=bound, bound_by="bytes", max_abs_err=err)
                row["library_ms"] = row["plain_ms"]
                line += (f" | kernel {row['ms']:.4f} ms, plain sequence {row['plain_ms']:.4f} ms, "
                         f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) | "
                         f"{bound / row['ms']:.1%} of 3.35 TB/s | {smi_clock_power()}")
                if case == LN_MAIN:
                    rows_out["add_layer_norm"] = row
            log(line)
            del x, d, s, y, ws, wy
    # every bf16 value as an input (exp(-a) overflowing and underflowing, the
    # division's slow path, subnormals, infinities): a bf16 output depends on
    # its input alone, so this covers every bf16 input; NaN counts as NaN
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        got, want = quick_gelu(every.to(dtype)), gelu_twin(every.to(dtype))
        same = (got.view(bits) == want.view(bits)) | (got.isnan() & want.isnan())
        assert bool(same.all()), (f"QuickGELU differs from its twin on {int((~same).sum())} "
                                  f"bf16 inputs in {dtype}")
        log(f"[k3] quick_gelu {str(dtype).split('.')[-1]} on all {every.numel()} bf16 values: "
            f"bit-identical to the twin")
    for shape in gelu_cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
            x.view(-1)[::97] = -0.0
            got, want = quick_gelu(x), gelu_twin(x)
            torch.cuda.synchronize()
            u = ulps_apart(got, want)
            name = str(dtype).split(".")[-1]
            line = (f"[k3] quick_gelu {list(shape)} {name}: "
                    + ("bit-identical to the twin" if int(u.max()) == 0 else
                       f"max {int(u.max())} ulps, {int((u > 0).sum())} of {u.numel()} differ"))
            assert int(u.max()) <= 1, line
            if shape in TIMED_GELU and dtype == torch.bfloat16:
                nbytes = 2 * x.numel() * x.element_size()
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                row = dict(ms=graph_ms(lambda: quick_gelu(x)),
                           plain_ms=graph_ms(lambda: gelu_twin(x)),
                           bound_ms=bound, bound_by="bytes",
                           max_abs_err=float((got.float() - want.float()).abs().max()))
                row["library_ms"] = row["plain_ms"]
                line += (f" | kernel {row['ms']:.4f} ms, plain sequence {row['plain_ms']:.4f} ms, "
                         f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) | "
                         f"{bound / row['ms']:.1%} of 3.35 TB/s | {smi_clock_power()}")
                if shape == GELU_MAIN:
                    rows_out["quick_gelu"] = row
            log(line)
            del x, got, want
    torch.cuda.empty_cache()

    # the wrappers' host cost a call, on a bank chunk's first rows (the bank
    # build is bound by the host's dispatch)
    x = torch.randn((16, 32, 512), generator=g, device=dev).to(torch.bfloat16)
    ln = SeededLN(512, g, dev)
    h = torch.randn((16, 32, 2048), generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        log(f"[k3] host us a call at [16, 32, 512] bf16: add_layer_norm "
            f"{host_us(lambda: add_layer_norm(x, x, ln)):.1f}, its plain sequence "
            f"{host_us(lambda: plain_ln(x, x, ln)):.1f}; quick_gelu "
            f"{host_us(lambda: quick_gelu(h)):.1f}, its twin {host_us(lambda: gelu_twin(h)):.1f}")
    return rows_out["add_layer_norm"], rows_out["quick_gelu"]


def phase_ln_features(tm, batch=512):
    """One batch of ViT image features through K3 held to the plain blocks'
    (``ln_act.autograd_records`` made to answer yes; K1 on both paths, the
    plain blocks' ``attention_scores`` substituted by it), both
    L2-normalised, with K3's launches in the encode and the tower's time on
    each path. Returns K3's launches of the encode."""
    from unittest import mock

    from hgr_tpu_torch.models import eva_vit, transformer
    from hgr_tpu_torch.models.clip import encode_image
    from hgr_tpu_torch.models.layers import l2_normalize
    from hgr_tpu_torch.ops import ln_act
    from hgr_tpu_torch.ops.attention import attention

    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=tm.device).manual_seed(4)
    images = torch.randn((batch, res, res, 3), generator=gen, device=tm.device)

    def encode():
        return encode_image(tm.model, images, dtype=tm.dtype)

    with torch.inference_mode():
        k3_reset()
        got = l2_normalize(encode()).float()
        launches = k3_launches()
        k3_ms = cuda_ms(encode, reps=3, warmup=1)
        with mock.patch.object(ln_act, "autograd_records", lambda *a: True), \
                mock.patch.object(transformer, "attention_scores", attention), \
                mock.patch.object(eva_vit, "attention_scores", attention):
            k3_reset()
            want = l2_normalize(encode()).float()
            assert k3_launches() == K3_NONE, k3_launches()
            plain_ms = cuda_ms(encode, reps=3, warmup=1)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    err = float((got - want).abs().max())
    expected = ln_act_launches(tm.clip_cfg, image_batches=1)
    log(f"[k3] {tm.config.arch} {batch} images, normalised features, K3 vs the plain blocks, "
        f"bf16: max_abs_err {err:.3e} (tol 1e-2), min row cosine {float(cos.min()):.6f} (tol "
        f"0.999); K3 launches {launches} (want {expected}); tower {k3_ms:.2f} ms with K3, "
        f"{plain_ms:.2f} ms plain")
    assert launches == expected, launches
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "ViT features through K3 disagree"
    return launches


def phase_slice(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=512, batches=4,
                launches_expected=432, image_launches=0, folder="runs/chip_smoke",
                checkpoint=None):
    """The zero-shot eval path at full width; returns (tm, bank, summary,
    K1 launches during run_test, K2 launches during run_test, K3's and the
    rotary's launches during run_test, as ``K3_NAMES`` orders them).
    ``launches_expected`` is K1's count in one bank build, ``image_launches``
    its count in one image batch; K2's is ``rn_epilogues`` a batch, K3's
    ``ln_act_launches`` of the bank's chunks and the batches. With
    ``checkpoint`` (an OpenAI-layout ``.pt``), its weights and architecture
    replace ``arch``'s (``TreeModel.load_torch``)."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.driver import build_model, run_test, synthetic_splits
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act
    from hgr_tpu_torch.utils.logging import RunLogger

    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    cfg = Config(arch=arch, synthetic=True, train=False, test_batch_size=batch,
                 synthetic_images_per_class=batch, max_test_batches=batches, folder=folder)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    splits = synthetic_splits(hier, cfg.seed)
    t0 = time.time()
    tm = build_model(cfg, hier, splits, device=dev)
    if checkpoint:
        tm.load_torch(checkpoint)
        arch = f"{arch} <- {checkpoint}"
    log(f"[slice] {arch}: {hier.num_nodes} classes, bank rows {tm.n_pad}, tokens T = "
        f"{tm.node_tokens.shape[1]}; model built in {time.time() - t0:.1f} s: {tm.clip_cfg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the bank alone, timed
    attention.launches = 0
    k3_reset()
    sync()
    t0 = time.time()
    bank = tm.update_classifier()
    sync()
    bank_ms = (time.time() - t0) * 1e3
    n, k3 = attention.launches, k3_launches()
    cuda = dev.type == "cuda"
    k3_bank = ln_act_launches(tm.clip_cfg, bank_chunks(tm)) if cuda else K3_NONE
    log(f"[slice] bank build {bank_ms:.1f} ms on {name}; K1 launches {n}; K3 and rotary "
        f"({', '.join(K3_NAMES)}) {k3} (want {k3_bank})")
    assert n == launches_expected, f"K1 launched {n} times in the bank build, not {launches_expected}"
    assert k3 == k3_bank, f"K3 launched {k3} times in the bank build, not {k3_bank}"
    assert bank.shape == (tm.n_pad, tm.clip_cfg.embed_dim), bank.shape
    assert bool(torch.isfinite(bank).all()), "bank not finite"

    # the main path: counts reset just before, read just after
    attention.launches = bn_act.launches = 0
    k3_reset()
    summary = run_test(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    launches, k2, k3 = attention.launches, bn_act.launches, k3_launches()
    log(f"[slice] run_test: {json.dumps(summary)}")
    k2_want = batches * rn_epilogues(tm.clip_cfg) if cuda else 0
    k3_want = ln_act_launches(tm.clip_cfg, bank_chunks(tm), batches) if cuda else K3_NONE
    log(f"[slice] K1 launches during run_test: {launches}; K2 launches: {k2} (want {k2_want}); "
        f"K3: {k3} (want {k3_want})")
    want = launches_expected + image_launches * batches
    assert launches == want, f"K1 launched {launches} times in run_test, not {want}"
    assert k2 == k2_want, f"K2 launched {k2} times in run_test, not {k2_want}"
    assert k3 == k3_want, f"K3 launched {k3} times in run_test, not {k3_want}"
    assert summary["num_samples"] == batches * batch, summary["num_samples"]
    assert all(math.isfinite(v) for v in summary.values()), summary

    # per-batch eval step on a batch already on the device
    bank_s = tm.sort_bank(bank)
    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((batch, res, res, 3), generator=gen, device=dev)
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    target = int(tm.test_index[0])
    if cuda:
        step_ms = cuda_ms(lambda: tm.eval_step_sorted(bank_s, images, target, valid), reps=5, warmup=2)
        log(f"[slice] eval step {step_ms:.2f} ms per batch of {batch} = "
            f"{batch / step_ms * 1e3:.0f} images/s (device-resident batch); run_test "
            f"{summary['imgs_per_sec']:.0f} images/s with the synthetic loader; on {name}; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return tm, bank, summary, launches, k2, k3


def phase_plain_bank(tm, bank):
    """Rebuild the bank with the plain attention and hold it to K1's."""
    with plain_attention():
        plain = tm.update_classifier()
    cos = torch.nn.functional.cosine_similarity(bank.float(), plain.float(), dim=-1)
    err = float((bank.float() - plain.float()).abs().max())
    log(f"[bank] kernel vs plain attention, bf16: max_abs_err {err:.3e} (tol 1e-2), "
        f"min row cosine {float(cos.min()):.6f} (tol 0.999)")
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "kernel bank disagrees with plain bank"


def phase_fp32_bank(tm):
    """The RN50 bank at full width in float32, through K1's fp32 kernel
    (12 layers x 36 chunks = 432 launches at (512, 8, 32, 64) causal),
    timed and held within ``TOL[torch.float32]`` to the bank built with the
    plain attention. Returns K1's launches in the first build."""
    from hgr_tpu_torch.ops.attention import attention

    fp32 = dataclasses.replace(tm, config=tm.config.replace(dtype="float32"))

    def timed():
        torch.cuda.synchronize()
        t0 = time.time()
        out = fp32.update_classifier()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    attention.launches = 0
    bank, cold_ms = timed()
    launches = attention.launches
    assert launches == 432, f"K1 launched {launches} times in the fp32 bank build, not 432"
    warm_ms = timed()[1]
    with plain_attention():
        plain, plain_ms = timed()
    assert bank.dtype == torch.float32 and bool(torch.isfinite(bank).all()), "fp32 bank"
    atol, rtol = TOL[torch.float32]
    diff = (bank - plain).abs()
    err = float(diff.max())
    worst = float((diff / (atol + rtol * plain.abs())).max())
    log(f"[bank-fp32] {tuple(bank.shape)} float32 bank build, K1 {launches} launches: "
        f"{cold_ms:.1f} ms cold, {warm_ms:.1f} ms warm; plain attention {plain_ms:.1f} ms; "
        f"max_abs_err {err:.3e}, {worst:.3f} of tol ({atol:g} + {rtol:g}|p|)")
    assert worst <= 1.0, "fp32 kernel bank disagrees with the plain bank"
    return launches


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
    attention's; both L2-normalised, as ``bank_logits`` uses them. The
    rotary launches as ``ln_act_launches`` counts on each path (L an EVA-02
    encode, 0 otherwise)."""
    from hgr_tpu_torch.models.clip import encode_image
    from hgr_tpu_torch.models.layers import l2_normalize
    from hgr_tpu_torch.ops.rope import rotary

    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=tm.device).manual_seed(3)
    images = torch.randn((batch, res, res, 3), generator=gen, device=tm.device)
    rotaries = (ln_act_launches(tm.clip_cfg, image_batches=1)[K3_NAMES.index("rotary")]
                if torch.device(tm.device).type == "cuda" else 0)
    with torch.inference_mode():
        n = rotary.launches
        got = l2_normalize(encode_image(tm.model, images, dtype=tm.dtype)).float()
        got_rot = rotary.launches - n
        with plain_attention():
            want = l2_normalize(encode_image(tm.model, images, dtype=tm.dtype)).float()
        want_rot = rotary.launches - n - got_rot
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    err = float((got - want).abs().max())
    log(f"[vit] {batch} images, normalised features, kernel vs plain attention, bf16: "
        f"max_abs_err {err:.3e} (tol 1e-2), min row cosine {float(cos.min()):.6f} (tol 0.999); "
        f"rotary launches {got_rot} and {want_rot} (want {rotaries})")
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "ViT features through K1 disagree"
    assert got_rot == want_rot == rotaries, (got_rot, want_rot, rotaries)


def run_counting_launches(fn, *args):
    """``fn(*args)`` (a driver's train run) with K1's launches split at the
    test after training: returns the result and ``{"train_steps": n,
    "test": m}``, K2's forward's as ``k2_train_steps`` and ``k2_test``, its
    backward's as ``k2b_train_steps`` and ``k2b_test``, and K3's
    and the rotary's (``K3_NAMES``) as ``k3_train_steps`` and
    ``k3_test``. A
    spy on the path, not on what it computes."""
    from hgr_tpu_torch import driver
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward

    seen = {}
    real = driver.run_test

    def run_test_spy(*a, **kw):
        seen["train_steps"], seen["k2_train_steps"] = attention.launches, bn_act.launches
        seen["k2b_train_steps"] = bn_act_backward.launches
        seen["k3_train_steps"] = k3_launches()
        out = real(*a, **kw)
        seen["test"] = attention.launches - seen["train_steps"]
        seen["k2_test"] = bn_act.launches - seen["k2_train_steps"]
        seen["k2b_test"] = bn_act_backward.launches - seen["k2b_train_steps"]
        seen["k3_test"] = tuple(n - m for n, m in zip(k3_launches(), seen["k3_train_steps"]))
        return out

    driver.run_test = run_test_spy
    attention.launches = bn_act.launches = bn_act_backward.launches = 0
    k3_reset()
    try:
        out = fn(*args)
    finally:
        driver.run_test = real
    return out, seen


def check_k3_train(tag, dev, tm, seen, test_batches, frozen_encodes=0):
    """K3 inside a train run's steps (none where both towers run under
    autograd; CoOp's frozen image tower, ``frozen_encodes`` of them, runs
    fused where it is a ViT, and its text tower carries the learned
    context's gradient) and in the test after them (the bank's text encodes
    and the test batches' ViT encodes)."""
    cuda = dev.type == "cuda"
    steps = ln_act_launches(tm.clip_cfg, image_batches=frozen_encodes) if cuda else K3_NONE
    test = ln_act_launches(tm.clip_cfg, bank_chunks(tm), test_batches) if cuda else K3_NONE
    log(f"[{tag}] K3 and rotary launches ({', '.join(K3_NAMES)}): "
        f"{seen['k3_train_steps']} inside "
        f"the train steps (want {steps}), {seen['k3_test']} in the test after them (want {test})")
    assert seen["k3_train_steps"] == steps, seen
    assert seen["k3_test"] == test, seen


def train_log(logger):
    """The losses of a run's ``metrics.jsonl``, the host-clock ms between
    consecutive steps and their median."""
    records = [json.loads(line) for line in open(logger.jsonl_path)]
    train = [r for r in records if r["event"] == "train"]
    step_ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(train, train[1:])]
    return [r["loss"] for r in train], step_ms, statistics.median(step_ms)


def _card_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


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

    # a spy on the path, not on what it computes: the prompts each schedule
    # asks to encode (run_counting_launches spies K1's count)
    prompts = []
    real_build = ScheduleBuilder.build

    def build_spy(self, target):
        sched = real_build(self, target)
        prompts.append((len(np.unique(sched.compare[sched.compare_valid])), len(sched.unique)))
        return sched

    logger = RunLogger(cfg.save_path, echo=False)
    _reset_peak(dev)
    ScheduleBuilder.build = build_spy
    t0 = time.time()
    try:
        state, seen = run_counting_launches(driver.run_train, cfg, tm, splits, logger)
    finally:
        ScheduleBuilder.build = real_build
    wall = time.time() - t0
    peak = _peak_gib(dev)

    losses, step_ms, med = train_log(logger)
    perf = [r for r in map(json.loads, open(logger.jsonl_path)) if r["event"] == "epoch_perf"][0]
    log(f"[train] {arch} bf16 remat, batch {batch}, {num_compare} negatives, {hier.num_nodes} "
        f"classes (bank rows {tm.n_pad}), {len(losses)} steps in {wall:.1f} s of run_train")
    log(f"[train] losses {losses}")
    log(f"[train] step ms after the first: {[round(x, 1) for x in step_ms]}, median {med:.1f} ms "
        f"= {batch / med * 1e3:.1f} images/s; epoch_perf {perf['step_ms']} ms a step over all "
        f"steps, {perf['imgs_per_sec']} images/s; prompts a step (distinct, encoded) {prompts}; "
        f"peak memory {peak:.2f} GiB; on {_card_name(dev)}")
    assert len(losses) == episodes and all(math.isfinite(x) for x in losses), losses
    sd = tm.model.state_dict()
    for k in watched:
        assert not torch.equal(sd[k], before[k]), f"{k} did not move"
    assert not torch.equal(tm.layer_weight.detach(), lw_before), "layer_weight did not move"
    log(f"[train] K1 launches: {seen['train_steps']} inside the train steps, "
        f"{seen['test']} in the test after them")
    assert seen["train_steps"] == 0, "K1 ran inside a train step"
    assert seen["test"] == bank_launches, seen
    k2_steps, k2_test = ((n * rn_epilogues(tm.clip_cfg) if dev.type == "cuda" else 0)
                         for n in (episodes, test_batches))
    log(f"[train] K2 launches (forward, backward): ({seen['k2_train_steps']}, "
        f"{seen['k2b_train_steps']}) inside the train steps (want {k2_steps} each: its autograd "
        f"Function), ({seen['k2_test']}, {seen['k2b_test']}) in the test after them (want "
        f"{k2_test}, 0)")
    assert (seen["k2_train_steps"], seen["k2b_train_steps"]) == (k2_steps, k2_steps), seen
    assert (seen["k2_test"], seen["k2b_test"]) == (k2_test, 0), seen
    check_k3_train("train", dev, tm, seen, test_batches)

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


def phase_train_accum(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=1024, accum=2,
                      num_compare=256, updates=2):
    """The OM step under gradient accumulation at full width: batch
    ``batch`` as ``accum`` microbatches of ``batch // accum`` (bf16, remat,
    ``num_compare`` negatives), ``updates`` full updates. Within an update
    no parameter moves before its last microbatch, and then the watched
    ones and ``layer_weight`` do; K1 and K3 launch 0 times (every
    microbatch runs under autograd), K2 forward and backward ``rn_epilogues``
    times a microbatch (its autograd Function). Logs the last update's
    host-clock ms."""
    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, init_train_state,
                                     make_optimizer, make_train_step, sched_to_device)

    cfg = Config(arch=arch, synthetic=True, remat=True, batch_size=batch // accum,
                 num_compare=num_compare, accum_steps=accum)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    tm = driver.build_model(cfg, hier, driver.synthetic_splits(hier, cfg.seed), device=dev)
    deep = hier.level(hier.max_depth)
    builder = ScheduleBuilder(hier, NegativeSampler(hier, tm.train_index, num_compare, seed=0),
                              cfg.out_ratio, cfg.in_ratio, num_compare)
    scheds = [sched_to_device(builder.build(int(deep[k])), dev) for k in range(accum)]
    res = tm.clip_cfg.image_resolution
    g = torch.Generator(device=dev).manual_seed(0)
    images = [torch.randint(0, 256, (cfg.batch_size, res, res, 3), generator=g, device=dev,
                            dtype=torch.uint8) for _ in range(accum)]
    tx = make_optimizer(cfg, 10 * updates)
    state = init_train_state(tm.model, tm.layer_weight, tx)
    step = make_train_step(cfg, tx, dtype=tm.dtype)
    node_tokens = torch.as_tensor(tm.node_tokens, device=dev).long()
    trained = dict(tm.model.named_parameters(), layer_weight=tm.layer_weight)
    watched = ("visual.conv1.weight", "visual.attnpool.c_proj.weight",
               "transformer.resblocks.0.attn.in_proj_weight", "layer_weight")

    attention.launches = bn_act.launches = bn_act_backward.launches = 0
    k3_reset()
    _reset_peak(dev)
    losses = []
    for u in range(updates):
        before = {k: t.detach().clone() for k, t in trained.items()}
        _sync(dev)
        t0 = time.perf_counter()
        for k in range(accum):
            _, loss = step(state, images[k], node_tokens, scheds[k])
            losses.append(float(loss))
            if k + 1 < accum:
                moved = [n for n, t in trained.items() if not torch.equal(t.detach(), before[n])]
                assert not moved, f"update {u}, microbatch {k}: {moved[:4]} moved"
                assert state.opt_state.mini_step == k + 1 and state.opt_state.count == u
        _sync(dev)
        update_ms = (time.perf_counter() - t0) * 1e3
        still = [n for n in watched if torch.equal(trained[n].detach(), before[n])]
        assert not still, f"update {u}: {still} did not move"
        assert state.opt_state.mini_step == 0 and state.opt_state.count == u + 1
    seen = (attention.launches, bn_act.launches, bn_act_backward.launches, k3_launches())
    k2 = updates * accum * rn_epilogues(tm.clip_cfg) if dev.type == "cuda" else 0
    want = (0, k2, k2, K3_NONE)
    log(f"[train-accum] {arch} bf16 remat, batch {batch} as {accum} x {cfg.batch_size}, "
        f"{num_compare} negatives, {updates} updates: losses {losses}; parameters still after "
        f"each non-last microbatch, moved after the last; last update {update_ms:.1f} ms = "
        f"{batch / update_ms * 1e3:.1f} images/s (host clock); peak memory {_peak_gib(dev):.2f} "
        f"GiB; K1, K2 forward, K2 backward, K3 launches {seen} (want {want}); on "
        f"{_card_name(dev)}")
    assert all(math.isfinite(x) for x in losses), losses
    assert seen == want, seen
    return seen


def phase_train_reference(dev, archs=("TEST-ViT", "TEST-RN")):
    """One OM train step in float32 on the card and on the port's CPU path
    from the same weights, images and schedule (remat on), for each of
    ``archs``: the loss within 1e-5 relative, the updated weights within
    5e-3 relative + 3e-5 wherever the gradient is above 1e-6 (AdamW's first
    step is about lr * sign(g), so a gradient at rounding level may flip its
    sign). TEST-RN's card step runs K2's autograd Function, ``rn_epilogues``
    forward and as many backward launches (the CPU step its plain twins),
    so the whole update with K2's backward is held to the CPU path."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import synthetic_hierarchy
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, freeze_params,
                                     init_train_state, make_om_loss_fn, make_optimizer,
                                     make_train_step, sched_to_device)
    from hgr_tpu_torch.tree_model import TreeModel

    for arch in archs:
        cfg = Config(arch=arch, dtype="float32", batch_size=4, num_compare=6, remat=True,
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
            bn_act.launches = bn_act_backward.launches = 0
            _, loss = step(state, torch.from_numpy(images).to(tm.device),
                           torch.as_tensor(tm.node_tokens, device=tm.device).long(),
                           sched_to_device(sched, tm.device))
            out[name] = (float(loss), {k: v.cpu() for k, v in tm.model.state_dict().items()},
                         tm.layer_weight.detach().cpu(), (bn_act.launches, bn_act_backward.launches))
        (lc, pc, wc, _), (lg, pg, wg, k2) = out["cpu"], out["card"]
        rel = abs(lg - lc) / abs(lc)
        worst = float("-inf")
        for k, g in grads.items():
            m = g.abs() > 1e-6
            excess = (pg[k][m] - pc[k][m]).abs() - (3e-5 + 5e-3 * pc[k][m].abs())
            worst = max(worst, float(excess.max()) if m.any() else -1.0)
        lw_err = float((wg - wc).abs().max())
        k2_want = (rn_epilogues(sides["card"].clip_cfg),) * 2 if dev.type == "cuda" else (0, 0)
        log(f"[train-small] one float32 OM step of {arch}, card vs cpu: loss {lg:.7f} vs "
            f"{lc:.7f} (rel {rel:.2e}, tol 1e-5); updated weights: largest excess over 3e-5 + "
            f"5e-3|w| {worst:.3e} (must be <= 0); layer_weight max_abs_err {lw_err:.2e}; K2 "
            f"launches (forward, backward) on the card {k2} (want {k2_want})")
        assert rel <= 1e-5 and worst <= 0 and lw_err <= 3e-5 + 5e-3 * float(wc.abs().max())
        assert k2 == k2_want, (arch, k2, k2_want)


def phase_coop(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=256, num_compare=256, episodes=4,
               test_batches=2, bank_launches=432, folder="runs/chip_smoke_coop"):
    """CoOp OM training at full width through ``driver.run_train`` with
    ``--coop --coop_train ctx``: every loss finite, the context moved, every
    CLIP tensor bitwise as it was, no K1 launch inside a train step and
    ``bank_launches`` in the test after them (the CoOp bank), ``clip_0``
    holds the context; then the CoOp bank through K1 held to the one built
    with the plain attention. Returns K1's and K2's launches
    (``run_counting_launches``'s counts)."""
    import os
    import shutil

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.eval.bank import build_bank_ids
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.utils.checkpoint import restore_params
    from hgr_tpu_torch.utils.logging import RunLogger

    cfg = Config(arch=arch, synthetic=True, train=True, remat=True, coop=True, coop_train="ctx",
                 batch_size=batch, num_compare=num_compare, epochs=1, n_episodes=episodes,
                 test_after_train=True, max_test_batches=test_batches, test_batch_size=batch,
                 synthetic_images_per_class=batch, print_freq=1, folder=folder)
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    splits = driver.synthetic_splits(hier, cfg.seed)
    tm = driver.build_model(cfg, hier, splits, device=dev)
    static, ctx0 = tm.coop_setup(cfg.seed)
    before = {k: v.clone() for k, v in tm.model.state_dict().items()}
    logger = RunLogger(cfg.save_path, echo=False)
    _reset_peak(dev)
    t0 = time.time()
    _, seen = run_counting_launches(driver.run_train, cfg, tm, splits, logger)
    wall = time.time() - t0
    peak = _peak_gib(dev)
    losses, step_ms, med = train_log(logger)
    log(f"[coop] {arch} bf16 remat, coop_train ctx, batch {batch}, {num_compare} negatives, "
        f"prompt length T = {static.tokenized.shape[1]} (n_ctx {static.n_ctx}), bank rows "
        f"{tm.n_pad}; {len(losses)} steps in {wall:.1f} s of run_train")
    log(f"[coop] losses {losses}")
    log(f"[coop] step ms after the first: {[round(x, 1) for x in step_ms]}, median {med:.1f} ms "
        f"= {batch / med * 1e3:.1f} images/s; peak memory {peak:.2f} GiB; on {_card_name(dev)}")
    assert len(losses) == episodes and all(math.isfinite(x) for x in losses), losses
    assert not torch.equal(tm.coop_ctx.detach().cpu(), ctx0.cpu()), "coop_ctx did not move"
    moved = [k for k, v in tm.model.state_dict().items() if not torch.equal(v, before[k])]
    assert not moved, f"CLIP tensors moved under coop_train ctx: {moved[:5]}"
    log(f"[coop] K1 launches: {seen['train_steps']} inside the train steps, {seen['test']} in "
        f"the test after them; all {len(before)} CLIP tensors bitwise unchanged")
    # CLIP is frozen, so each step's image tower takes K2
    k2_steps, k2_test = (n * rn_epilogues(tm.clip_cfg) for n in (episodes, test_batches))
    log(f"[coop] K2 launches: {seen['k2_train_steps']} inside the train steps (want {k2_steps}), "
        f"{seen['k2_test']} in the test after them (want {k2_test})")
    assert seen["train_steps"] == 0, "K1 ran inside a train step"
    assert seen["test"] == bank_launches, seen
    assert (seen["k2_train_steps"], seen["k2_test"]) == (k2_steps, k2_test), seen
    assert (seen["k2b_train_steps"], seen["k2b_test"]) == (0, 0), seen  # no gradient to CLIP
    check_k3_train("coop", dev, tm, seen, test_batches, frozen_encodes=episodes)
    saved = restore_params(os.path.join(cfg.save_path, "clip_0"))
    assert torch.equal(saved["coop_ctx"], tm.coop_ctx.detach().cpu()), "clip_0's coop_ctx"

    # the CoOp bank through K1 against the plain attention's (not counted)
    params = {"clip": tm.model, "coop_ctx": tm.coop_ctx}
    chunk = min(512, tm.n_pad)
    text_fn = tm.coop_text_fn(static)
    got = build_bank_ids(params, tm.n_pad, text_fn, chunk, tm.dtype, dev).float()
    with plain_attention():
        want = build_bank_ids(params, tm.n_pad, text_fn, chunk, tm.dtype, dev).float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    err = float((got - want).abs().max())
    log(f"[coop] bank of {tm.n_pad} CoOp prompts, kernel vs plain attention, bf16: max_abs_err "
        f"{err:.3e} (tol 1e-2), min row cosine {float(cos.min()):.6f} (tol 0.999)")
    assert err <= 1e-2 and float(cos.min()) >= 0.999, "CoOp bank through K1 disagrees"
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    return seen


def phase_flat(dev, arch="RN50", level_sizes=LEVEL_SIZES, batch=256, n_seen=1000, steps=4,
               test_batches=2, bank_launches=432, folder="runs/chip_smoke_flat"):
    """Flat fine-tuning at full width through ``driver.run_train`` with
    ``--training_method flat``: ``n_seen`` seen classes drawn from the seed
    (the reference's regime is about 1,000), every step encoding all their
    prompts; ``steps`` batches (two images each of ``steps * batch / 2``
    seen classes), then ``run_test``. Every loss finite, the CLIP weights
    moved and ``layer_weight`` not, no K1 launch inside a step and
    ``bank_launches`` in the test. Returns K1's and K2's launches
    (``run_counting_launches``'s counts)."""
    import shutil

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.utils.logging import RunLogger

    cfg = Config(arch=arch, synthetic=True, train=True, training_method="flat", batch_size=batch,
                 epochs=1, data_train="smoke_flat", synthetic_images_per_class=2,
                 test_after_train=True, max_test_batches=test_batches, test_batch_size=batch,
                 print_freq=1, folder=folder)
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    perm = np.random.default_rng(cfg.seed).permutation(hier.num_nodes)
    seen_cls = [hier.names[i] for i in sorted(perm[:n_seen])]
    rest = [hier.names[i] for i in sorted(perm[n_seen:])]
    splits = {"train": seen_cls, "rest": rest, "all": seen_cls + rest,
              "smoke_flat": seen_cls[: steps * batch // 2]}
    tm = driver.build_model(cfg, hier, splits, device=dev)
    sd = tm.model.state_dict()
    watched = [k for k in ("visual.conv1.weight", "visual.attnpool.c_proj.weight",
                           "transformer.resblocks.0.attn.in_proj_weight", "logit_scale")
               if k in sd]
    before = {k: sd[k].clone() for k in watched}
    lw_before = tm.layer_weight.detach().clone()
    logger = RunLogger(cfg.save_path, echo=False)
    _reset_peak(dev)
    t0 = time.time()
    _, seen = run_counting_launches(driver.run_train_flat, cfg, tm, splits, logger)
    wall = time.time() - t0
    peak = _peak_gib(dev)
    losses, step_ms, med = train_log(logger)
    log(f"[flat] {arch} bf16, batch {batch}, {n_seen} seen prompts a step (T = "
        f"{tm.node_tokens.shape[1]}), {len(losses)} steps in {wall:.1f} s of run_train_flat")
    log(f"[flat] losses {losses}")
    log(f"[flat] step ms after the first: {[round(x, 1) for x in step_ms]}, median {med:.1f} ms "
        f"= {batch / med * 1e3:.1f} images/s; peak memory {peak:.2f} GiB; on {_card_name(dev)}")
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), losses
    sd = tm.model.state_dict()
    for k in watched:
        assert not torch.equal(sd[k], before[k]), f"{k} did not move"
    assert torch.equal(tm.layer_weight.detach(), lw_before), "layer_weight moved"
    k2_steps, k2_test = (n * rn_epilogues(tm.clip_cfg) for n in (steps, test_batches))
    log(f"[flat] K1 launches: {seen['train_steps']} inside the train steps, {seen['test']} in "
        f"the test after them; K2 launches (forward, backward) ({seen['k2_train_steps']}, "
        f"{seen['k2b_train_steps']}) inside the train steps (want {k2_steps} each), "
        f"({seen['k2_test']}, {seen['k2b_test']}) in the test (want {k2_test}, 0)")
    assert seen["train_steps"] == 0, "K1 ran inside a train step"
    assert seen["test"] == bank_launches, seen
    assert (seen["k2_train_steps"], seen["k2b_train_steps"]) == (k2_steps, k2_steps), seen
    assert (seen["k2_test"], seen["k2b_test"]) == (k2_test, 0), seen
    check_k3_train("flat", dev, tm, seen, test_batches)
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    return seen


# the baselines at the reference's widths: 512-d class embeddings (CLIP
# text features), 2,048-d prototypes and features (a ResNet-50's)
BASELINE_RUNS = {
    "gcn": ["--baseline", "gcn", "--variant", "dense_att", "--attr_dim", "512",
            "--feat_dim", "2048", "--hid_dim", "2048", "--steps", "40"],
    "cnzsl": ["--baseline", "cnzsl", "--attr_dim", "512", "--feat_dim", "2048",
              "--hid_dim", "1024", "--steps", "40"],
    "free": ["--baseline", "free", "--attr_dim", "512", "--feat_dim", "2048",
             "--syn_num", "32", "--steps", "20"],
    "clip_flat": ["--baseline", "clip_flat", "--steps", "20"],
}
# K1's launches in CLIP-flat's bank: TEST-RN's 2 text layers x 36 chunks of
# 512 prompts (18,278 classes padded to 18,432)
CLIP_FLAT_BANK_LAUNCHES = 2 * 36


# run in this process (``baselines.run.main``): a runner process spends
# 18-30 s before its work, and GCN keeps the CLI's own check
BASELINES_IN_PROCESS = ("cnzsl", "free", "clip_flat")


def run_baseline(flags, device_index=0, in_process=False):
    """The runner's standard output for ``flags``: ``python -m
    hgr_tpu_torch.baselines.run`` in a subprocess on the card, or its
    ``main`` in this process."""
    if in_process:
        import contextlib
        import io

        from hgr_tpu_torch.baselines import run

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run.main(flags, device=f"cuda:{device_index}")
        return buf.getvalue()
    cmd = [sys.executable, "-m", "hgr_tpu_torch.baselines.run", *flags,
           "--device", str(device_index)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, f"{flags[:2]}: " + p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


def phase_baselines(graph_path, split_path, device_index=0, runs=BASELINE_RUNS,
                    bank_launches=CLIP_FLAT_BANK_LAUNCHES, in_process=BASELINES_IN_PROCESS):
    """Each baseline through the runner (``in_process`` ones by its
    ``main``, the others as ``python -m hgr_tpu_torch.baselines.run``
    subprocesses) on the card, over the real-input phase's hierarchy and
    splits: its last line must parse and every metric be finite, and
    CLIP-flat's bank must launch K1 ``bank_launches`` times. Prints each
    run's wall time and the runner's own training line (steps/s, peak
    memory). Returns the bank's K1 launches."""
    seen = None
    for name, flags in runs.items():
        t0 = time.time()
        out = run_baseline([*flags, "--synthetic", "False", "--graph_path", graph_path,
                            "--split_path", split_path], device_index, name in in_process)
        wall = time.time() - t0
        lines = out.strip().splitlines()
        summary = json.loads(lines[-1])
        assert summary.pop("baseline") == name, lines[-1]
        assert summary["num_samples"] > 0 and all(math.isfinite(v) for v in summary.values()), \
            summary
        for line in lines:
            if line.startswith("# "):
                log(f"[baselines] {name}: {line[2:]}")
            if line.startswith("# K1 launches in the bank: "):
                seen = int(line.rsplit(" ", 1)[1])
        log(f"[baselines] {name}: {wall:.1f} s of "
            f"{'main() in this process' if name in in_process else 'command'}; "
            f"{json.dumps(summary)}")
    if "clip_flat" in runs:
        assert seen == bank_launches, \
            f"CLIP-flat's bank launched K1 {seen} times, not {bank_launches}"
    return seen


def phase_steps_reference(dev):
    """One float32 step of the CoOp OM loss (coop_train both), of the flat
    step, of CNZSL, GCN (dense_att, with dropout masks) and FREE (a D step
    then a G step) on the card and on the port's CPU path, from the same
    weights, inputs and draws: every loss within 1e-5 relative (1e-5
    absolute under 1), every parameter within 3e-5 + 5e-3|w| wherever its
    CPU gradient is above 1e-6 (the gradient read back from Adam's first
    moment, m / (1 - b1): Adam's first step is about lr * sign(g), so a
    gradient at rounding level may flip its sign)."""
    from hgr_tpu_torch.baselines import cnzsl, free, gcn
    from hgr_tpu_torch.baselines.clip_flat import make_flat_train_step
    from hgr_tpu_torch.baselines.optim import Adam, from_numpy
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import synthetic_hierarchy
    from hgr_tpu_torch.models.coop import coop_ctx_init
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, init_train_state,
                                     make_optimizer, make_train_step, sched_to_device)
    from hgr_tpu_torch.train.trainer import Optimizer
    from hgr_tpu_torch.tree_model import TreeModel

    hier = synthetic_hierarchy(3, 4, 5, 0)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    cfg = Config(arch="TEST-ViT", dtype="float32", batch_size=4, num_compare=6, remat=True,
                 lr=1e-3, w_lr=1e-2, coop=True, coop_train="both")
    weights = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
    weights = weights.init_params(0).state_dict()
    ctx0 = coop_ctx_init(torch.Generator().manual_seed(1), 16, 32)
    target = int(hier.level(hier.max_depth)[3])

    def tree_model(device):
        tm = TreeModel.build(cfg, hier, pad_multiple=64, device=device)
        tm.load_state_dict(weights)
        return tm

    def coop_step(device):
        tm = tree_model(device)
        static, _ = tm.coop_setup(0)
        sched = ScheduleBuilder(hier, NegativeSampler(hier, tm.train_index, 6, seed=0,
                                                      topk_window="both"),
                                cfg.out_ratio, cfg.in_ratio, 6).build(target)
        tx = make_optimizer(cfg, 10, extra_labels={"coop_ctx": "clip"})
        state = init_train_state(tm.model, tm.layer_weight, tx,
                                 extra_params={"coop_ctx": ctx0.to(device, copy=True)})
        step = make_train_step(cfg, tx, dtype=torch.float32,
                               text_fn=tm.coop_text_fn(static))
        _, loss = step(state, torch.from_numpy(images).to(device),
                       torch.as_tensor(tm.node_tokens, device=device).long(),
                       sched_to_device(sched, device))
        return [float(loss)], [state.opt_state.adamw]

    def flat_step(device):
        tm = tree_model(device)
        tx = Optimizer(cfg.replace(accum_steps=1), 10, {"clip": "clip"})
        params = {"clip": tm.model}
        opt = tx.init(params)
        _, _, loss = make_flat_train_step(tx, torch.float32)(
            params, opt, torch.from_numpy(images).to(device),
            torch.as_tensor(tm.node_tokens[:26], device=device).long(),
            torch.as_tensor([3, 0, 25, 7], device=device))
        return [float(loss)], [opt.adamw]

    feats = rng.standard_normal((16, 64)).astype(np.float32)
    attrs = rng.standard_normal((hier.num_nodes, 32)).astype(np.float32)
    protos = rng.standard_normal((hier.num_nodes, 64)).astype(np.float32)
    labels = rng.integers(0, 10, 16)

    def cnzsl_step(device):
        c = cnzsl.CNZSLConfig(attr_dim=32, proto_dim=64, hid_dim=64)
        params, state = cnzsl.cnzsl_init(torch.Generator().manual_seed(0), c)
        params, state = from_numpy(params, device), from_numpy(state, device, False)
        tx = Adam(1e-3)
        opt = tx.init(params)
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        _, _, _, loss = cnzsl.make_cnzsl_train_step(c, tx)(params, state, opt, t(feats),
                                                           t(attrs[:10]), t(labels))
        return [float(loss)], [opt]

    def gcn_step(device):
        groups = gcn.dense_edges(hier, max_hops=4)
        n = hier.num_nodes
        adj = [gcn.Adjacency.build(g, n, device=device) for g in groups]
        radj = [gcn.Adjacency.build(g, n, transpose=True, device=device) for g in groups]
        c = gcn.GCNConfig(n=n, in_channels=32, out_channels=64, hidden_layers="d64,d",
                          mode="dense_att", n_hops=len(groups))
        params = from_numpy(gcn.gcn_init(torch.Generator().manual_seed(0), c), device)
        masks = [m if m is None else m.to(device)
                 for m in gcn.draw_dropout_masks(torch.Generator().manual_seed(1), c)]
        tx = Adam(1e-3)
        opt = tx.init(params)
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        _, _, loss = gcn.make_gcn_train_step(c, tx, adj, radj)(
            params, opt, t(attrs), t(protos), t(np.arange(0, n, 2)), masks)
        return [float(loss)], [opt]

    fc = free.FREEConfig(res_size=64, att_size=16, latent_size=16, ngh=128, ndh=128,
                         nclass_seen=10, critic_iter=1, center_margin=20.0)
    g = torch.Generator().manual_seed(2)
    d_draws, g_draws = free.draw_d(g, fc, 16, 10), free.draw_g(g, fc, 16)
    feat01 = rng.random((16, 64)).astype(np.float32)

    def free_step(device):
        params = from_numpy(free.free_init(torch.Generator().manual_seed(0), fc), device)
        d_step, g_step, init_opts = free.make_free_steps(fc)
        optD, optFR, optC, optEG = init_opts(params)
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        lab = t(labels)
        others = free.other_labels(lab, 10, d_draws["offsets"].to(device))
        out = d_step(params, optD, optFR, optC, t(feat01), t(attrs[:16, :16]), lab, others, 10.0,
                     {k: v.to(device) for k, v in d_draws.items()})
        _, _, g_loss = g_step(params, optEG, t(feat01), t(attrs[:16, :16]),
                              {k: v.to(device) for k, v in g_draws.items()})
        return [float(x) for x in out[4:]] + [float(g_loss)], [optD, optFR, optC, optEG]

    for name, fn in (("CoOp OM step", coop_step), ("flat step", flat_step),
                     ("CNZSL step", cnzsl_step), ("GCN dense_att step", gcn_step),
                     ("FREE D and G steps", free_step)):
        (lc, oc), (lg, og) = fn("cpu"), fn(dev)
        loss_err = max(abs(b - a) / max(abs(a), 1.0) for a, b in zip(lc, lg))
        worst, n_cmp = float("-inf"), 0
        for opt_c, opt_g in zip(oc, og):
            b1 = opt_c.param_groups[0]["betas"][0]
            for pc, pg in zip((p for grp in opt_c.param_groups for p in grp["params"]),
                              (p for grp in opt_g.param_groups for p in grp["params"])):
                m = (opt_c.state[pc]["exp_avg"] / (1 - b1)).abs() > 1e-6
                w = pc.detach()[m]
                if m.any():
                    excess = (pg.detach().cpu()[m] - w).abs() - (3e-5 + 5e-3 * w.abs())
                    worst = max(worst, float(excess.max()))
                    n_cmp += int(m.sum())
        log(f"[steps-small] {name}, float32, card vs cpu: losses {lg} vs {lc} (largest error "
            f"{loss_err:.2e}, tol 1e-5); {n_cmp} updated weights, largest excess over 3e-5 + "
            f"5e-3|w| {worst:.3e} (must be <= 0)")
        assert loss_err <= 1e-5 and worst <= 0 and n_cmp > 0, name


def write_openai_pt(clip_cfg, path, seed):
    """Seeded weights of ``clip_cfg`` as OpenAI ships them: an fp16
    ``state_dict`` under OpenAI's names, BatchNorm counters included."""
    from hgr_tpu_torch.models.clip import clip_init

    sd = clip_init(clip_cfg, torch.Generator().manual_seed(seed)).state_dict()
    sd = {k: v.half() for k, v in sd.items()}
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    torch.save(sd, path)
    return sum(v.numel() for v in sd.values())


class SeededRows:
    """An image source of seeded uint8 rows, keyed by the image's path: what
    the decode cache is built from where no image files exist. Each row is
    a 2 x 2 grid of seeded colours under seeded noise: random weights give
    rows of uniform noise nearly one feature vector (cosine 0.99999 between
    two), which would leave every image of a class the same outcome."""

    def __init__(self, resolution):
        self.resolution = resolution

    def load(self, class_name, paths, idx):
        import zlib

        r = self.resolution
        rng = np.random.default_rng(zlib.crc32(paths[idx].encode()))
        cell = -(-r // 2)
        grid = np.repeat(np.repeat(rng.integers(0, 256, (2, 2, 3)), cell, 0), cell, 1)[:r, :r]
        return np.clip(grid + rng.integers(-16, 17, (r, r, 3)), 0, 255).astype(np.uint8)


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
    the same metrics. Returns what the serving phase needs and K1's and K2's
    launches in ``run_test`` (``launches``, ``k2``)."""
    import os
    import time as _time
    from collections import Counter

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.data import GroupedTestLoader
    from hgr_tpu_torch.data.decode_cache import CachedImageSource, build_cache
    from hgr_tpu_torch.hierarchy import Hierarchy, profiled_edges
    from hgr_tpu_torch.models.clip import get_config
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act
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
    write_openai_pt(clip_cfg, path["pt"], seed=1)
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
    attention.launches = bn_act.launches = 0
    summary = driver.run_test(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    launches, k2 = attention.launches, bn_act.launches
    num = summary["num_samples"]
    k2_want = -(-num // batch) * rn_epilogues(tm.clip_cfg) if dev.type == "cuda" else 0
    log(f"[real] run_test from the decode cache: {json.dumps(summary)}")
    log(f"[real] K1 launches during run_test: {launches} (T = {t_cut}); K2 launches {k2} "
        f"(want {k2_want})")
    assert launches == bank_launches, f"K1 launched {launches} times, not {bank_launches}"
    assert k2 == k2_want, f"K2 launched {k2} times, not {k2_want}"
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
    return dict(tm=tm, args=cli, cfg_args=args, names=names, launches=launches, k2=k2,
                test4=test4, seen=splits["train"], paths=path, summary=summary, save_path=cfg.save_path)


def phase_files_and_serving(real, fixtures=None):
    """Files through ``FileImageSource`` and serving, when this machine can
    decode: the decoder in use and its time per image, the corrupt file's
    fallback, ``classify_files`` over the fixtures tiled to 64 paths (K1
    rebuilds the bank), and ``python -m hgr_tpu_torch.serve`` on three of
    them. Returns K1's and K2's launches in ``classify_files``, or None when
    no decoder exists (the check that needs none ran in the real-input
    phase)."""
    import time as _time
    from pathlib import Path

    from hgr_tpu_torch.data import FileImageSource
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act
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
    attention.launches = bn_act.launches = 0
    out = clf.classify_files(paths, k=5, batch=64)
    launches, k2 = attention.launches, bn_act.launches
    first, gap, moved = {}, 0.0, 0
    for p, row in zip(paths, out):
        assert len(row) == 5 and all(math.isfinite(s) for _, s in row), row
        # copies of one file at other rows of the bf16 batch
        want = first.setdefault(p, row)
        gap = max(gap, max(abs(s - w) for (_, s), (_, w) in zip(row, want)))
        moved += [c for c, _ in row] != [c for c, _ in want]
    log(f"[files] classify_files over {len(paths)} paths: K1 launches {launches}, K2 launches "
        f"{k2} (want {rn_epilogues(tm.clip_cfg)}, one batch); copies of one "
        f"file at other rows of the batch: largest score gap {gap:.3e}, top-5 order changed in "
        f"{moved} of {len(paths) - len(good)}; top-1 {[first[p][0] for p in good]}")
    assert gap <= DUP_ROW_ATOL, f"copies of one file differ by {gap:.3e} > {DUP_ROW_ATOL}"
    assert launches == 432 or tm.n_pad != 18432, launches
    assert k2 == rn_epilogues(tm.clip_cfg), k2

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
    return launches, k2


def phase_vit_l14(dev, work):
    """ViT-L/14 eval at full width (the zoo's ``"ViT-L/14"``: vision 1024
    wide, 24 layers of 16 heads, patch 14, so T = 257; text 768 wide, 12
    heads) through the user's route: an OpenAI-layout fp16 ``.pt`` with
    seeded weights, whose architecture ``sniff_config`` reads as the zoo's,
    loaded by ``TreeModel.load_torch`` into the zoo name's model, and
    ``run_test`` over one batch of 512 against the 18,432-row bank (K1: 12
    x 36 = 432 launches in the bank, 24 in the image tower at T = 257),
    then one batch's features through K1 held to the plain attention's, and
    through K3 to the plain blocks'. Returns K1's and K3's launches in
    ``run_test`` and K3's in that one encode."""
    import os

    from hgr_tpu_torch.models.clip import get_config
    from hgr_tpu_torch.models.convert import sniff_config

    cfg = get_config("ViT-L/14")
    path = os.path.join(work, "vit_l14.pt")
    t0 = time.time()
    n = write_openai_pt(cfg, path, seed=2)
    log(f"[vit-l14] {n / 1e6:.1f} M parameters, {os.path.getsize(path) / 1e9:.2f} GB fp16 "
        f"written in {time.time() - t0:.1f} s")
    sniffed = sniff_config(torch.load(path, map_location="cpu", mmap=True, weights_only=True))
    assert sniffed == cfg, f"the file reads as {sniffed}, not the zoo's {cfg}"
    tm, _, _, launches, _, k3 = phase_slice(dev, arch="ViT-L/14", batches=1, image_launches=24,
                                            checkpoint=path, folder="runs/chip_smoke_vit_l14")
    assert tm.clip_cfg == cfg
    phase_vit_features(tm)
    k3_encode = phase_ln_features(tm)
    os.remove(path)
    return launches, k3, k3_encode


# the gate kernel's cases (rows, n, dtype): EVA02-CLIP-L/14's blocks (512 x
# 257 tokens, 2,730 columns padded to 2,736) in bf16 and fp32, then odd
# sizes: a single row, a persistent block's ragged tail at n = 10, no pad (n
# = 2048), the widest np (3072, fp32 with 5 pad columns over two vectors)
GLU_CASES = [(131584, 2730, torch.bfloat16), (131584, 2730, torch.float32),
             (1, 2730, torch.bfloat16), (13, 10, torch.bfloat16), (13, 10, torch.float32),
             (1001, 2048, torch.bfloat16), (77, 3072, torch.bfloat16), (77, 3067, torch.float32)]
GLU_MAIN = (131584, 2730, torch.bfloat16)


def glu_bytes(rows, n, dtype) -> int:
    """The gate's bytes: the padded row of 2 np read, np written."""
    return rows * 3 * (-(-n // 8) * 8) * dtype.itemsize


def glu_float64_errors(x12, n, ln, got, want):
    """The largest ``|y - y64|`` over the n real columns of the kernel's y
    (``got``) and the twin's (``want``), and on how many values each lies
    strictly closer to y64 than the other: y64 is ``ffn_ln`` in float64 of
    the twin's g (SiLU and the product rounded to ``x12``'s dtype, as the
    twin rounds them) with the weight and bias rounded to that dtype."""
    np_, dt = x12.shape[-1] // 2, x12.dtype
    g = torch.nn.functional.silu(x12[:, :n]) * x12[:, np_:np_ + n]
    y64 = torch.nn.functional.layer_norm(g.double(), (n,), ln.weight.to(dt).double(),
                                         ln.bias.to(dt).double(), ln.eps)
    del g
    e_got = (got[:, :n].double() - y64).abs()
    e_want = (want[:, :n].double() - y64).abs()
    return ((float(e_got.max()), float(e_want.max())),
            (int((e_got < e_want).sum()), int((e_want < e_got).sum())))


def check_glu_layer_norm(dev, cases=GLU_CASES):
    """K3's SwiGLU gate and ``ffn_ln`` against its plain twin
    (``models.layers.glu_layer_norm``) on the card, on the w1/w2 GEMM's
    padded output (its pad columns zero, as the GEMM's zero rows give
    them): bf16 within one ulp of the larger of the twin's ``|y|`` and the
    bias (as ``add_layer_norm``), fp32 within ``TOL``, the pad columns +0.0;
    ``GLU_MAIN`` timed by CUDA-graph replay against its bytes at 3.35 TB/s
    beside the twin. At ``GLU_MAIN`` both are held to ``ffn_ln`` in float64
    of the twin's g (``glu_float64_errors``): the kernel's largest error
    may not exceed the twin's. First the gate's SiLU and product alone
    (``hgr_silu_mul``) on every bf16 value, bit for bit PyTorch's: in bf16
    the kernel's SiLU comes from approximations (``silu_bf16``), so this
    covers every input it can see. Returns the kernel-table row of
    ``GLU_MAIN``."""
    from hgr_tpu_torch.models.layers import glu_layer_norm as twin
    from hgr_tpu_torch.ops import ln_act
    from hgr_tpu_torch.ops.ln_act import glu_layer_norm

    g = torch.Generator(device=dev).manual_seed(6)
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        a = every.to(dtype)
        for name, b in (("1", torch.ones_like(a)),
                        ("drawn", (torch.randn(a.shape, generator=g, device=dev) * 2).to(dtype))):
            got = torch.empty_like(a)
            ln_act._launch(ln_act._library().hgr_silu_mul, a.get_device(), ln_act._DTYPES[dtype],
                           a.data_ptr(), b.data_ptr(), got.data_ptr(), a.numel())
            want = torch.nn.functional.silu(a) * b
            same = (got.view(bits) == want.view(bits)) | (got.isnan() & want.isnan())
            assert bool(same.all()), (f"the gate's SiLU(a) * b differs from PyTorch's on "
                                      f"{int((~same).sum())} bf16 values of a in {dtype}, b {name}")
        log(f"[k3] glu_layer_norm's SiLU(a) * b {str(dtype).split('.')[-1]} on all {a.numel()} "
            f"bf16 values of a, b 1 and drawn: bit-identical to PyTorch's")
    out = None
    for case in cases:
        rows, n, dtype = case
        np_ = -(-n // 8) * 8
        x12 = torch.randn((rows, 2 * np_), generator=g, device=dev) * 2.0
        x12[:, n:np_] = 0.0
        x12[:, np_ + n:] = 0.0
        x12 = x12.to(dtype)
        ln = SeededLN(n, g, dev)
        ln.eps = 1e-6
        got, want = glu_layer_norm(x12, ln), twin(x12, ln.weight, ln.bias, ln.eps)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        pad = got[:, n:].contiguous().view(bits)
        assert got.shape == want.shape == (rows, np_) and bool((pad == 0).all()), \
            f"the gate's pad columns are not +0.0 at {case}"
        u = ulps_apart(got[:, :n], want[:, :n])
        diff = (got.float() - want.float()).abs()
        name = str(dtype).split(".")[-1]
        if dtype == torch.bfloat16:
            scale = torch.maximum(want.float().abs(),
                                  torch.nn.functional.pad(ln.bias.to(dtype).float().abs(),
                                                          (0, np_ - n)))
            ok, tol = bool((diff <= bf16_ulp(scale)).all()), "1 ulp of max(|y|, |b|)"
        else:
            atol, rtol = TOL[dtype]
            ok, tol = bool((diff <= atol + rtol * want.float().abs()).all()), \
                f"{atol:g} + {rtol:g}|p|"
        line = (f"[k3] glu_layer_norm [{rows}, {2 * np_}] n = {n} {name}: y max {int(u.max())} "
                f"ulps ({int((u > 1).sum())} over 1), {int((u > 0).sum())} of {u.numel()} "
                f"differ, max |diff| {float(diff.max()):.3e} (tol {tol}); pad columns +0.0")
        assert ok, line
        if case == GLU_MAIN:
            (k_err, t_err), (k_closer, t_closer) = glu_float64_errors(x12, n, ln, got, want)
            f64 = (f"[k3] glu_layer_norm {name} against float64 ffn_ln of the twin's g: "
                   f"max |err| kernel {k_err:.6e}, twin {t_err:.6e}; kernel strictly closer "
                   f"on {k_closer}, twin on {t_closer} of {rows * n} values")
            log(f64)
            assert k_err <= t_err, f64
            nbytes = glu_bytes(rows, n, dtype)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out = dict(ms=graph_ms(lambda: glu_layer_norm(x12, ln)),
                       plain_ms=graph_ms(lambda: twin(x12, ln.weight, ln.bias, ln.eps)),
                       bound_ms=bound, bound_by="bytes", max_abs_err=float(diff.max()),
                       max_ulps=int(u.max()), f64_err=k_err, plain_f64_err=t_err)
            out["library_ms"] = out["plain_ms"]
            line += (f" | kernel {out['ms']:.4f} ms, plain sequence {out['plain_ms']:.4f} ms, "
                     f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) | "
                     f"{bound / out['ms']:.1%} of 3.35 TB/s | {smi_clock_power()}")
        log(line)
        del x12, got, want, diff, u
    torch.cuda.empty_cache()
    return out


# the rotary kernel's cases (B, T, rows of the buffer, Dh, dtype), each on the
# first two thirds of a [B, T, rows, Dh] buffer's rows as the q and k of the
# q/k/v GEMM's output: EVA02-CLIP-L/14's (16 heads, T = 257) in bf16 and
# fp32, TEST-EVA's (2 heads, T = 17); then odd sizes: a batch that is not
# whole row groups (5), a single row of 8 channels, a head of 72 (nine
# 8-channel chunks), a position's rows of more than 256 chunks (a block's
# threads loop), and Dh 128
ROTARY_CASES = [(512, 257, 48, 64, torch.bfloat16), (512, 257, 48, 64, torch.float32),
                (4, 17, 6, 64, torch.bfloat16), (5, 17, 6, 64, torch.float32),
                (1, 1, 3, 8, torch.bfloat16), (3, 10, 6, 72, torch.float32),
                (7, 37, 96, 64, torch.bfloat16), (2, 5, 48, 128, torch.bfloat16)]
ROTARY_MAIN = ROTARY_CASES[0]


def rotary_bytes(B, T, rows, dh, dtype) -> int:
    """The rotary's bytes: the q and k rows read and written, the fp32
    tables read."""
    return 2 * B * T * rows * dh * dtype.itemsize + 2 * T * dh * 4


def rotary_three_pass(t, cos, sin):
    """The EVA-02 tower's rotary before its kernel: the pair swap, ``t *
    cos`` and ``addcmul`` on the tables cast to ``t``'s dtype ([T, 1, Dh],
    cast once an encode), each rounded to that dtype."""
    swapped = t.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(t * cos, swapped, sin)


def check_rotary(dev, cases=ROTARY_CASES):
    """The rotary kernel (``ops.rope.rotary``) against its twin
    (``models.layers.rotary``) on the card, on the strided q and k rows of
    a [B, T, 3H, Dh] buffer: within one ulp of the dtype, the share that
    differs stated; EVA's tables where T is EVA02-CLIP-L/14's or TEST-EVA's,
    drawn ones elsewhere. At ``ROTARY_MAIN``, the kernel, the twin and the
    three-pass sequence the tower ran before (``rotary_three_pass``) held
    to the float64 turn (the largest error in bf16 ulps of ``|x cos| +
    |x' sin|``: the kernel's at most half of one, as one rounding gives),
    and the three timed by CUDA-graph replay beside the bytes'
    bound at 3.35 TB/s. Returns the kernel-table row of ``ROTARY_MAIN``."""
    from hgr_tpu_torch.models.eva_vit import ROPE_REF_GRID, rope_tables
    from hgr_tpu_torch.models.layers import rotary as twin, swap_pairs
    from hgr_tpu_torch.ops.rope import rotary

    g = torch.Generator(device=dev).manual_seed(8)
    out = None
    for case in cases:
        B, T, rows, dh, dtype = case
        grid = round((T - 1) ** 0.5)
        if dh == 64 and grid in (16, 4) and grid * grid + 1 == T:
            cos, sin = (t.to(dev) for t in rope_tables(grid, ROPE_REF_GRID, dh))
        else:
            cos, sin = (torch.rand((T, dh), generator=g, device=dev) * 2 - 1 for _ in range(2))
        buf = torch.randn((B, T, rows, dh), generator=g, device=dev) * 3
        x = buf.to(dtype)[:, :, :2 * rows // 3]
        del buf
        n = rotary.launches
        got, want = rotary(x, cos, sin), twin(x, cos, sin)
        torch.cuda.synchronize()
        assert rotary.launches == n + 1 and got.is_contiguous() and got.shape == x.shape
        u = ulps_apart(got, want)
        name = str(dtype).split(".")[-1]
        line = (f"[rotary] [{B}, {T}, {x.shape[2]}, {dh}] {name} (row stride {x.stride(1)}): "
                f"{int((u > 0).sum())} of {u.numel()} values differ from the twin "
                f"({float((u > 0).float().mean()):.4%}), max {int(u.max())} ulps (tol 1)")
        assert int(u.max()) <= 1, line
        if case == ROTARY_MAIN:
            cos_t, sin_t = (t.to(dtype)[:, None] for t in (cos, sin))
            old = rotary_three_pass(x, cos_t, sin_t)
            xc, xs = x.double() * cos.double()[:, None], swap_pairs(x).double() * sin.double()[:, None]
            y64, ulp = xc + xs, bf16_ulp((xc.abs() + xs.abs()).float()).double()
            del xc, xs
            errs = {k: float(((v.double() - y64).abs() / ulp).max())
                    for k, v in (("kernel", got), ("twin", want), ("three-pass", old))}
            del y64, ulp, old
            f64 = (f"[rotary] {name} against the float64 turn: largest error in bf16 ulps of "
                   f"|x cos| + |x' sin| kernel {errs['kernel']:.4f}, twin {errs['twin']:.4f}, "
                   f"three-pass sequence {errs['three-pass']:.4f}")
            log(f64)
            assert errs["kernel"] <= min(0.5 + 2 ** -6, errs["three-pass"]), f64
            nbytes = rotary_bytes(B, T, x.shape[2], dh, dtype)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out = dict(ms=graph_ms(lambda: rotary(x, cos, sin)),
                       plain_ms=graph_ms(lambda: twin(x, cos, sin)),
                       three_pass_ms=graph_ms(lambda: rotary_three_pass(x, cos_t, sin_t)),
                       bound_ms=bound, bound_by="bytes", max_ulps=int(u.max()),
                       differ_share=float((u > 0).float().mean()), f64_ulps=errs["kernel"],
                       three_pass_f64_ulps=errs["three-pass"])
            out["library_ms"] = out["plain_ms"]
            line += (f" | kernel {out['ms']:.4f} ms, twin {out['plain_ms']:.4f} ms, three-pass "
                     f"sequence {out['three_pass_ms']:.4f} ms, bound {bound:.4f} ms "
                     f"({nbytes / 1e9:.3f} GB) | {bound / out['ms']:.1%} of 3.35 TB/s | "
                     f"{smi_clock_power()}")
        log(line)
        del x, got, want, u
    torch.cuda.empty_cache()
    return out


def check_eva_autograd(tm, batch=8):
    """An EVA-02 image encode with a weight of its last SwiGLU requiring a
    gradient: the plain blocks run, K3 (its gate among it) and the rotary
    launch nothing, and the gradient reaches the weight."""
    from hgr_tpu_torch.models.clip import encode_image

    res = tm.clip_cfg.image_resolution
    gen = torch.Generator(device=tm.device).manual_seed(5)
    images = torch.randn((batch, res, res, 3), generator=gen, device=tm.device)
    w = tm.model.visual.blocks[-1].mlp.w1.weight
    k3_reset()
    w.requires_grad_(True)
    try:
        with torch.enable_grad():
            encode_image(tm.model, images, dtype=tm.dtype).float().square().sum().backward()
        reached = w.grad is not None and bool(w.grad.abs().sum() > 0)
    finally:
        w.requires_grad_(False)
        w.grad = None
    log(f"[eva02] {batch} images under autograd: K3 and rotary launches {k3_launches()} (want "
        f"{K3_NONE}); "
        f"gradient reached the last block's w1: {reached}")
    assert k3_launches() == K3_NONE and reached


def phase_eva02_l14(dev):
    """EVA02-CLIP-L/14 eval at full width (the zoo's ``"EVA02-CLIP-L/14"``:
    EVA-02's block, vision 1024 wide, 24 layers of 16 heads, 2-D rotary,
    SwiGLU 2,730 wide, patch 14, so T = 257; the GELU text tower 768 wide,
    12 heads) with seeded weights: K3's gate against its twin
    (``check_glu_layer_norm``) and the rotary against its twin
    (``check_rotary``), then ``run_test`` over one batch of 512 against the
    18,432-row bank (K1: 432 launches in the bank, 24 in the image tower;
    K3 and the rotary as ``ln_act_launches`` counts: no QuickGELU, the gate
    and the rotary 0 in the bank and 24 an image encode), then one batch's
    features through K1 held to the plain attention's (24 rotaries on each
    path), and through K3 and the rotary to the plain blocks' (none on the
    plain path), and an encode under autograd (neither). Returns K1's and
    K3's launches in ``run_test``, K3's in that one encode, and the gate's
    and the rotary's kernel-table rows."""
    glu_row = check_glu_layer_norm(dev)
    rotary_row = check_rotary(dev)
    tm, _, _, launches, _, k3 = phase_slice(dev, arch="EVA02-CLIP-L/14", batches=1,
                                            image_launches=24,
                                            folder="runs/chip_smoke_eva02_l14")
    phase_vit_features(tm)
    k3_encode = phase_ln_features(tm)
    check_eva_autograd(tm)
    return launches, k3, k3_encode, glu_row, rotary_row


# SigLIP So400m's two K1 launches at full size: an image batch's (512
# images, 16 heads, T = 729) and a bank chunk's (512 prompts, T = 64), both
# at head dim 72 without a mask
SIGLIP_K1_SHAPES = ((512, 16, 729, 72), (512, 16, 64, 72))
SIGLIP_K1_MAIN = SIGLIP_K1_SHAPES[0]


def chunked(fn, rows=64):
    """``fn`` over q, k, v (and a mask) in slices of ``rows`` prompts: the
    plain attention at T = 729 holds [rows, 16, 729, 729] fp32 scores."""
    def run(q, k, v, mask=None):
        return torch.cat([fn(q[i:i + rows], k[i:i + rows], v[i:i + rows], mask)
                          for i in range(0, q.shape[0], rows)])
    return run


def check_siglip_attention(dev):
    """K1 at head dim 72, bf16, at ``SIGLIP_K1_SHAPES``: held to the plain
    attention (in slices of 64 prompts) within ``TOL``, then timed by
    CUDA-graph replay beside SDPA and its bound; the plain version by CUDA
    events. Returns the image launch's kernel-table row."""
    import torch.nn.functional as F

    from hgr_tpu_torch.models.layers import attention_scores
    from hgr_tpu_torch.ops.attention import attention

    g = torch.Generator(device=dev).manual_seed(72)
    rows = {}
    for shape in SIGLIP_K1_SHAPES:
        q, k, v = qkv_views(shape, torch.bfloat16, "packed", g, dev)
        got, want = attention(q, k, v), chunked(attention_scores)(q, k, v)
        torch.cuda.synchronize()
        atol, rtol = TOL[torch.bfloat16]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        assert bool((diff <= atol + rtol * want.float().abs()).all()), \
            f"K1 at head dim 72 disagrees with the plain attention at {shape}: {err}"
        del got, want, diff
        bound, by = attention_bound_ms(shape, torch.bfloat16, None)
        row = dict(ms=graph_ms(lambda: attention(q, k, v)),
                   plain_ms=cuda_ms(lambda: chunked(attention_scores)(q, k, v), reps=2, warmup=1),
                   library_ms=graph_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"[siglip] attention {shape} bf16 packed: max_abs_err {err:.3e} (tol {atol:g} + "
            f"{rtol:g}|p|) ok | kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}) | "
            f"{bound / row['ms']:.1%} of bound | {smi_clock_power()}")
        rows[shape] = row
        del q, k, v
        torch.cuda.empty_cache()
    return rows[SIGLIP_K1_MAIN]


def phase_siglip_so400m(dev):
    """SigLIP So400m/14 at 384 px eval at full width (the zoo's
    ``"SigLIP-SO400M/14@384"``: both towers 1,152 wide, 27 layers of 16
    heads of 72, MLP 4,304 with GELU's tanh form, T = 729 with no class
    token, the MAP head; a bidirectional text tower over 64 positions) with
    seeded weights: K1 at head dim 72 against its plain version and timed
    (``check_siglip_attention``), then ``run_test`` over one batch of 512
    against the 18,432-row bank (K1: 27 a bank chunk, 972 in the bank, and
    27 in the image tower; K3 as ``ln_act_launches`` counts: 2L + 1 a text
    encode and 2L + 1 an image encode, no QuickGELU), then the bank through
    the plain attention, and 128 images' features through K1 held to the
    plain attention's and through K3 to the plain blocks'. K3 at 1,152 is
    phase 3c's (``LN_ACT_CASES``). Returns K1's and K3's launches in
    ``run_test``, K3's in that one encode, and K1's row at T = 729."""
    k1_row = check_siglip_attention(dev)
    tm, bank, _, launches, _, k3 = phase_slice(dev, arch="SigLIP-SO400M/14@384", batches=1,
                                               launches_expected=27 * 36, image_launches=27,
                                               folder="runs/chip_smoke_siglip")
    assert tm.node_tokens.shape[1] == 64, "the bidirectional tower's bank was cut"
    phase_plain_bank(tm, bank)
    phase_vit_features(tm, batch=128)
    k3_encode = phase_ln_features(tm, batch=128)
    return launches, k3, k3_encode, k1_row


def seeded_jpegs(root, classes, per_class, seed=0):
    """``per_class`` JPEGs a class at ImageNet's usual size (500 x 375 or
    375 x 500, quality 90) under ``root/<wnid>/``, made by PIL from a seed:
    smooth colour fields with noise, so that they compress as photographs
    do. Returns ``{wnid: [relative paths]}``."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    grouped = {}
    for c in classes:
        os.makedirs(os.path.join(root, c), exist_ok=True)
        grouped[c] = []
        for j in range(per_class):
            w, h = (500, 375) if rng.random() < 0.75 else (375, 500)
            base = Image.fromarray(rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8))
            arr = np.asarray(base.resize((w, h), Image.BICUBIC), np.int16)
            arr = np.clip(arr + rng.integers(-12, 13, arr.shape), 0, 255).astype(np.uint8)
            rel = f"{c}/{j:04d}.JPEG"
            Image.fromarray(arr).save(os.path.join(root, rel), quality=90)
            grouped[c].append(rel)
    return grouped


def phase_decode(dev, real, n_procs, per_class=64, bank_launches=432):
    """Decode processes on the card's host: 512 seeded JPEGs over phase 9's
    4 test and 4 seen classes, decoded at 224 px by the loaders' 8 threads
    and by ``n_procs`` processes (rows byte-equal), each timed; then
    ``run_test`` on the test classes' files with ``--num_proc_workers``
    (the bank rebuilt: 432 K1 launches; ``rn_epilogues`` K2 launches a
    batch). Returns what the baselines' image phase needs."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.data import FileImageSource
    from hgr_tpu_torch.data.mp_decode import ProcessDecodePool
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act
    from hgr_tpu_torch.utils.logging import RunLogger

    work = os.path.dirname(real["paths"]["graph"])
    root = os.path.join(work, "jpeg")
    test, seen = real["test4"], real["seen"][:4]
    t0 = time.time()
    grouped = seeded_jpegs(root, test + seen, per_class)
    files = [p for c in grouped for p in grouped[c]]
    size = sum(os.path.getsize(os.path.join(root, p)) for p in files)
    manifests = {"test": os.path.join(work, "jpeg_test_split.json"),
                 "train": os.path.join(work, "jpeg_train_split.json")}
    for key, classes in (("test", test), ("train", seen)):
        with open(manifests[key], "w") as f:
            json.dump({c: grouped[c] for c in classes}, f)
    log(f"[decode] {len(files)} JPEGs of about 500 x 375 at quality 90 ({size / len(files) / 1e3:.1f} "
        f"kB each) written in {time.time() - t0:.1f} s")

    src = FileImageSource(224, image_root=root)
    decoder = "native libjpeg" if src.native else "PIL"
    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:
        rows = np.stack(list(pool.map(lambda p: src.load("", [p], 0), files)))
    thread_ms = (time.time() - t0) * 1e3 / len(files)
    with ProcessDecodePool(224, len(files), image_root=root, num_workers=n_procs) as mp_pool:
        mp_pool.decode_pairs([(p, p) for p in files[:n_procs]])  # the workers up and warm
        t0 = time.time()
        got = mp_pool.decode_pairs([(p, p) for p in files])
        proc_ms = (time.time() - t0) * 1e3 / len(files)
        cpu = mp_pool.cpu_s_per_image
    assert np.array_equal(got, rows), "decode processes and threads give different rows"
    log(f"[decode] {decoder} at 224 px, {len(files)} images: 8 threads {thread_ms:.2f} ms an image, "
        f"{n_procs} processes {proc_ms:.2f} ms an image ({thread_ms / proc_ms:.2f}x), rows "
        f"byte-equal; worker CPU {cpu * 1e3:.2f} ms an image ({os.cpu_count()} host cores)")

    args = list(real["cfg_args"])
    i = args.index("--decode_cache")
    del args[i: i + 2]
    args += ["--image_root", root, "--data_split_test", "jpeg_test", "--test_batch_size",
             str(per_class), "--num_proc_workers", str(n_procs)]
    cfg = Config.from_args(args)
    hier, splits = driver.build_hierarchy(cfg)
    attention.launches = bn_act.launches = 0
    summary = driver.run_test(cfg, real["tm"], splits, RunLogger(cfg.save_path, echo=False))
    launches, k2 = attention.launches, bn_act.launches
    k2_want = -(-summary["num_samples"] // per_class) * rn_epilogues(real["tm"].clip_cfg)
    log(f"[decode] run_test over the {len(test) * per_class} test JPEGs, --num_proc_workers "
        f"{n_procs}, batches of {per_class}: {summary['imgs_per_sec']:.0f} images/s, decode, "
        f"bank build and metrics included; K1 launches {launches}, K2 launches {k2} (want "
        f"{k2_want}); {json.dumps(summary)}")
    assert summary["num_samples"] == len(test) * per_class and launches == bank_launches, summary
    assert k2 == k2_want, f"K2 launched {k2} times, not {k2_want}"
    return dict(root=root, manifests=manifests, launches=launches, k2=k2,
                n_test=len(test) * per_class,
                n_seen=len(seen) * per_class)


def phase_baseline_images(dev, real, decoded, n_procs, batch=64):
    """The baselines' image path, the reference's DGP evaluation on image
    files: a seeded torchvision-layout ResNet-50 ``.pth``, then ``python -m
    hgr_tpu_torch.baselines.run --baseline gcn --cnn ... --refit_backbone``
    over phase 9's hierarchy and the JPEGs (8 refit steps of 64, decode
    processes): every metric finite and the refit backbone moved. Then, in
    this process, ``--cnn`` without the refit, ``tools/export_torch_image_
    feats.py`` over the same test manifest and ``--feature_file`` with the
    same GCN model: the counts must be the ``--cnn`` run's."""
    import importlib.util
    import os

    from hgr_tpu_torch.baselines import run
    from hgr_tpu_torch.models.resnet_std import resnet50_init
    from hgr_tpu_torch.utils.checkpoint import load_pytree

    work = os.path.dirname(real["paths"]["graph"])
    cnn = os.path.join(work, "resnet50.pth")
    sd = resnet50_init(torch.Generator().manual_seed(3)).state_dict()
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
               for k in list(sd) if k.endswith("running_mean")})
    torch.save(sd, cnn)
    idx = str(dev.index or 0)
    common = ["--baseline", "gcn", "--variant", "basic", "--attr_dim", "512", "--feat_dim", "2048",
              "--hid_dim", "512", "--steps", "20", "--synthetic", "False",
              "--graph_path", real["paths"]["graph"], "--split_path", real["paths"]["splits"],
              "--manifest", decoded["manifests"]["test"], "--eval_batch", str(batch),
              "--num_procs", str(n_procs)]
    images = ["--image_root", decoded["root"], "--cnn", cnn]
    t0 = time.time()
    out = run_baseline(common + images + [
        "--train_manifest", decoded["manifests"]["train"], "--refit_backbone", "--refit_steps",
        "8", "--refit_batch", str(batch), "--save_path", os.path.join(work, "gcn")], idx)
    wall = time.time() - t0
    lines = out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary.pop("baseline") == "gcn" and summary["num_samples"] == decoded["n_test"], summary
    assert all(math.isfinite(v) for v in summary.values()), summary
    for line in lines:
        if line.startswith("# ") or line.startswith("refit done"):
            log(f"[baseline-images] {line.lstrip('# ')}")
    refit = load_pytree(os.path.join(work, "gcn_refit"))["params"]
    moved = [k for k in ("conv1.weight", "layer4.2.conv3.weight", "layer4.2.bn3.running_var")
             if not torch.equal(refit[k], sd[k])]
    log(f"[baseline-images] `python -m hgr_tpu_torch.baselines.run --baseline gcn --cnn ... "
        f"--refit_backbone` in {wall:.1f} s: {json.dumps(summary)}; refit moved {moved}")
    assert len(moved) == 3, "the refit backbone equals the one loaded"

    # the same GCN model for the two evaluations below: index_add_ sums in
    # no fixed order on the card, so a second training could move a near tie
    real_gcn, memo = run.run_gcn, {}

    def gcn_once(*a, **kw):
        if "fn" not in memo:
            memo["fn"] = real_gcn(*a, **kw)
        return memo["fn"]

    run.run_gcn = gcn_once
    try:
        t0 = time.time()
        cnn_run = json.loads(run_baseline(common + images, idx, True).strip().splitlines()[-1])
        cnn_s = time.time() - t0
        spec = importlib.util.spec_from_file_location(
            "export_torch_image_feats",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                         "export_torch_image_feats.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        t0 = time.time()
        ff = tool.main(["--manifest", decoded["manifests"]["test"], "--image_root",
                        decoded["root"], "--cnn", cnn, "--out", os.path.join(work, "feats.npz"),
                        "--batch", str(batch), "--num_procs", str(n_procs), "--device", idx],
                       device=dev)
        export_s = time.time() - t0
        ff_run = json.loads(run_baseline(common + ["--feature_file", ff], idx, True)
                            .strip().splitlines()[-1])
    finally:
        run.run_gcn = real_gcn
    counts = ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20", "tor", "num_samples")
    log(f"[baseline-images] in process: --cnn {cnn_s:.1f} s; export_torch_image_feats "
        f"{export_s:.1f} s; --feature_file counts equal to --cnn's: "
        f"{all(ff_run[k] == cnn_run[k] for k in counts)} ({ {k: cnn_run[k] for k in counts} })")
    assert all(ff_run[k] == cnn_run[k] for k in counts), (ff_run, cnn_run)


def phase_resnet_reference(dev):
    """The standard ResNet-50 in fp32 on the card (cuDNN, TF32 off) against
    the port's CPU path, from the same weights, on 4 images at 64 px:
    features within 1e-4 of the largest, and one refit step (SGD with
    momentum under a frozen head, train-mode BatchNorm): the loss within
    2e-4 relative, the BatchNorm statistics within 1e-3, the weight updates
    within 10% (L2, per tensor) and at a cosine of 0.999 or more. The
    train-mode net at this size is chaotic: the port's own fp32 gradients
    differ from its fp64 ones by about 3% (``tests/test_torch_resnet_std.py``)."""
    import copy

    from hgr_tpu_torch.baselines import features, refit
    from hgr_tpu_torch.baselines.materials import inject_fc
    from hgr_tpu_torch.models.resnet_std import resnet50_init

    rng = np.random.default_rng(4)
    cpu = inject_fc(resnet50_init(torch.Generator().manual_seed(4)),
                    rng.normal(0, 0.05, (5, 2049)).astype(np.float32))
    card = copy.deepcopy(cpu).to(dev)
    old = {k: v.clone() for k, v in cpu.state_dict().items()}
    images = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    labels, valid = torch.tensor([0, 3, 1, 4]), torch.tensor([True, True, True, False])
    flip = torch.tensor([False, True, False, True])
    fc, fg = (features.make_featurizer(m, crop=56, dtype=torch.float32)(images) for m in (cpu, card))
    f_err = float((fg.cpu() - fc).abs().max()) / float(fc.abs().max())
    out = {}
    for name, m in (("cpu", cpu), ("card", card)):
        d = next(m.parameters()).device
        opt = torch.optim.SGD(m.base_parameters(), lr=1e-2, momentum=0.9)
        loss, _ = refit.make_refit_step(opt, 56, dtype=torch.float32)(
            m, images.to(d), labels.to(d), valid.to(d), flip.to(d))
        out[name] = (float(loss), {k: v.cpu() for k, v in m.state_dict().items()})
    (lc, pc), (lg, pg) = out["cpu"], out["card"]
    worst_l2, worst_stat, dc, dg = 0.0, 0.0, [], []
    for k in pc:
        if "running" in k:
            worst_stat = max(worst_stat, float((pg[k] - pc[k]).abs().max() / pc[k].abs().max()))
        elif not k.startswith("fc."):
            a, b = (pg[k] - old[k]).double(), (pc[k] - old[k]).double()
            worst_l2 = max(worst_l2, float((a - b).norm() / b.norm()))
            dg.append(a.flatten())
            dc.append(b.flatten())
    cos = float(torch.nn.functional.cosine_similarity(torch.cat(dg), torch.cat(dc), dim=0))
    rel = abs(lg - lc) / abs(lc)
    log(f"[resnet-small] fp32 card vs cpu: features max error {f_err:.2e} of the largest (tol "
        f"1e-4); one refit step: loss {lg:.6f} vs {lc:.6f} (rel {rel:.1e}, tol 2e-4), BatchNorm "
        f"statistics {worst_stat:.1e} (tol 1e-3), updates: worst L2 {worst_l2:.3f} (tol 0.1), "
        f"cosine {cos:.6f} (tol 0.999)")
    assert f_err <= 1e-4 and rel <= 2e-4 and worst_stat <= 1e-3 and worst_l2 <= 0.1
    assert cos >= 0.999 and torch.equal(pg["fc.weight"], pc["fc.weight"])


def phase_trace(dev, folder="runs/chip_smoke_trace"):
    """Two OM steps (RN50, batch 32) through ``driver.run_train`` with
    ``--trace_dir``: the window opens at step 1 and is closed when the
    epoch ends; one Chrome trace must be written, naming CUDA kernels."""
    import os
    import shutil

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.utils.logging import RunLogger

    shutil.rmtree(folder, ignore_errors=True)
    trace_dir = os.path.join(folder, "trace")
    cfg = Config(arch="RN50", synthetic=True, train=True, batch_size=32, num_compare=32,
                 epochs=1, n_episodes=2, synthetic_images_per_class=32, trace_dir=trace_dir,
                 folder=folder)
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device=dev)
    t0 = time.time()
    driver.run_train(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    traces = sorted(os.listdir(trace_dir))
    assert len(traces) == 1 and traces[0].endswith(".json"), traces
    path = os.path.join(trace_dir, traces[0])
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in kernels}, key=len)
    log(f"[trace] --trace_dir, 2 OM steps in {time.time() - t0:.1f} s: {traces[0]} "
        f"({os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, {len(kernels)} CUDA "
        f"kernel launches of {len(names)} kernels, e.g. {names[:3]})")
    assert kernels, "the trace names no CUDA kernel"
    shutil.rmtree(folder, ignore_errors=True)


def phase_export_text(dev, real, arch="RN50x4", bank_launches=432):
    """``tools/export_torch_text_feats.py`` over phase 9's hierarchy, names
    and merges at RN50x4's text width (640, 10 heads): one L2-normalised
    row a class, through K1 on the card (12 layers x 36 chunks). Returns
    K1's launches."""
    import importlib.util
    import os

    from hgr_tpu_torch.models.clip import get_config
    from hgr_tpu_torch.ops.attention import attention

    p = real["paths"]
    spec = importlib.util.spec_from_file_location(
        "export_torch_text_feats",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                     "export_torch_text_feats.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = os.path.join(os.path.dirname(p["graph"]), "text_feats.json")
    attention.launches = 0
    t0 = time.time()
    tool.main(["--graph_path", p["graph"], "--arch", arch, "--names_path", p["names"],
               "--vocab_path", p["vocab"], "--out", out, "--device", str(dev.index or 0)],
              device=dev)
    launches = attention.launches
    rows = np.asarray([r[0] for r in json.load(open(out))], np.float32)
    norms = np.linalg.norm(rows, axis=1)
    log(f"[export-text] {arch}: {rows.shape} features in {time.time() - t0:.1f} s, K1 launches "
        f"{launches}, row norms {norms.min():.4f}-{norms.max():.4f}")
    n = real["tm"].hier.num_nodes
    assert rows.shape == (n, get_config(arch).embed_dim) and np.isfinite(rows).all()
    assert launches == bank_launches, launches
    assert np.allclose(norms, 1.0, atol=1e-2)
    return launches



def phase_guard(dev):
    """K1, K2, K3 and the rotary refuse a call that autograd would record
    (K1, K3 and the rotary have no backward; K2's direct launch records no
    graph), and K2's
    autograd Function takes it: one forward and one backward launch, the
    gradient the twin's."""
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

    from hgr_tpu_torch.models.layers import batch_norm_act
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward

    from hgr_tpu_torch.ops.bn_act import bn_act_autograd

    x = torch.randn(2, 4, 4, 8, device=dev).permute(0, 3, 1, 2).requires_grad_(True)
    n, nb = bn_act.launches, bn_act_backward.launches
    try:
        bn_act(x, None, relu=True)
    except RuntimeError as e:
        log(f"[guard] bn_act on a CUDA tensor that requires grad raises: {e}")
    else:
        raise AssertionError("bn_act ran under autograd")
    assert (bn_act.launches, bn_act_backward.launches) == (n, nb)
    y = bn_act_autograd(x, None, relu=True)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    (want,) = torch.autograd.grad(batch_norm_act(x, None, relu=True), x, torch.ones_like(y))
    log(f"[guard] bn_act_autograd on it: {type(y.grad_fn).__name__}, one forward and one "
        f"backward launch, the gradient equal to the twin's")
    assert type(y.grad_fn).__name__ == "BnActBackward" and torch.equal(dx, want)
    assert (bn_act.launches, bn_act_backward.launches) == (n + 1, nb + 1)
    with torch.no_grad():
        assert bn_act(x, None, relu=True).grad_fn is None
    assert (bn_act.launches, bn_act_backward.launches) == (n + 2, nb + 1)

    from hgr_tpu_torch.ops.ln_act import add_layer_norm, glu_layer_norm, quick_gelu

    x = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    ln = SeededLN(64, torch.Generator(device=dev).manual_seed(0), dev)
    n = k3_launches()
    for call in (lambda: add_layer_norm(x, x.detach(), ln), lambda: quick_gelu(x),
                 lambda: glu_layer_norm(torch.cat((x, x), -1), ln)):
        try:
            call()
        except RuntimeError as e:
            log(f"[guard] ln_act on a CUDA tensor that requires grad raises: {e}")
        else:
            raise AssertionError("ln_act ran under autograd")
    assert k3_launches() == n
    with torch.no_grad():
        add_layer_norm(x, x, ln)
        quick_gelu(x)
        glu_layer_norm(torch.cat((x, x), -1), ln)
    assert k3_launches() == (n[0] + 1, n[1] + 1, n[2] + 1, n[3])

    from hgr_tpu_torch.ops.rope import rotary

    x = torch.randn(2, 8, 4, 64, device=dev, requires_grad=True)
    cos, sin = torch.ones(8, 64, device=dev), torch.zeros(8, 64, device=dev)
    try:
        rotary(x, cos, sin)
    except RuntimeError as e:
        log(f"[guard] rotary on a CUDA tensor that requires grad raises: {e}")
    else:
        raise AssertionError("rotary ran under autograd")
    assert rotary.launches == n[3]
    with torch.no_grad():
        assert torch.equal(rotary(x, cos, sin), x)
    assert rotary.launches == n[3] + 1


# ---- slice 7: the mesh over torch.distributed, and the offline builders ----

MESH_WORLD = 4
# (a): each image's merged top-20 test logits (cosines) against one
# process's, and the margin within which a prediction that differs must tie
# the best. The ranks run the image tower at half the batch and the bank
# product on quarter shards, shapes for which cuBLAS and cuDNN may pick other
# kernels, so bf16 features may round differently. Read: 4.3e-8 on the
# H100, 5.4e-5 on the CPU in fp32; two images of one class differ by about
# 3e-3 (RN50's random weights on the seeded colour grids)
MESH_VAL_ATOL = 1e-4
PRED_DIR_ENV = "CHIP_SMOKE_PRED_DIR"
COUNT_DIR_ENV = "CHIP_SMOKE_COUNT_DIR"
# (d): the SPMD step's first loss against one process's mean of the two
# replica losses (bf16, the towers at other batch sizes), and the cosine and
# the norm ratio of the gradients the two updates apply
SPMD_LOSS_RTOL = 1e-4
SPMD_GRAD_COS = 0.999
SPMD_GRAD_NORM_RTOL = 1e-2
# (e): sha256 of graph_edges_cls.json that the JAX package's builder writes
# from structure_xml(0) and builder_lists(0) (tests/test_torch_builders.py)
EXPECTED_BUILDER_SHA256 = "3c4cb7ea69ed3abee8e996b41b3870101ccaa861d9aa1b36f1edf8b170c5fd9c"


def phase_zstd():
    """What the Orbax reader needs of this host: the system's
    ``libzstd.so.1`` (its version), and g++, which would build a decoder of
    the port's own if the library were missing."""
    import shutil

    from hgr_tpu_torch.utils import zstd

    try:
        version = zstd.version("chip_smoke")
    except zstd.ZstdUnavailable as e:
        log(f"[device] {zstd.LIBRARY}: does not load ({e}); the Orbax phase will fail")
    else:
        log(f"[device] {zstd.LIBRARY}: loads, ZSTD_versionNumber {version}")
    log(f"[device] g++ on the path: {shutil.which('g++') or 'no'}")


# the Orbax fixtures (tests/torch_fixtures/make_orbax_fixtures.py): JAX's
# checkpoints of RN50 (with optax's state at step 7) and of a ResNet-50
# _refit, each leaf's digest, and JAX's fp32 CPU features of seeded inputs
ORBAX_SEEDS = dict(n_images=8, n_prompts=64, image_seed=11, prompt_seed=12)
ORBAX_STEP = 7
# fp32 on the card, TF32 off, against JAX's fp32 features on the CPU: the
# largest difference over the largest feature (0.7e-6 for the RN50 image
# tower on the CPU)
ORBAX_FEAT_RTOL = 1e-4
# the resumed update's norm against AdamW's formula on the carried moments
# (the update is about 1e-5 of the weights, so fp32 weights carry it to
# about 1%)
ORBAX_UPDATE_RTOL = 2e-2


def orbax_inputs(resolution, context_length, vocab_size, n_images, n_prompts, image_seed,
                 prompt_seed):
    """The fixtures' seeded inputs, made as ``make_orbax_fixtures.inputs``
    makes them: uint8 images and prompt tokens (start, 1-30 ids, end, zeros)."""
    images = np.random.default_rng(image_seed).integers(
        0, 256, (n_images, resolution, resolution, 3), dtype=np.uint8)
    rng = np.random.default_rng(prompt_seed)
    tokens = np.zeros((n_prompts, context_length), np.int32)
    for row in tokens:
        n = int(rng.integers(1, 31))
        row[0] = vocab_size - 2
        row[1:n + 1] = rng.integers(1, vocab_size - 2, n)
        row[n + 1] = vocab_size - 1
    return images, tokens


def leaf_digest(value):
    """dtype, shape and SHA-256 of a leaf as ``digests.json`` holds them."""
    import hashlib

    if isinstance(value, torch.Tensor):
        dtype = str(value.dtype).removeprefix("torch.")
        a = (value.view(torch.uint16) if value.dtype == torch.bfloat16 else value)
        a = a.contiguous().numpy()
    else:
        a = np.asarray(value)
        dtype = str(a.dtype)
    return {"dtype": dtype, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def cli_count(args, timeout=600):
    """The CLI (``driver.main(args)``) in a process of its own through this
    script's ``--cli-rank`` mode, as one rank of no world; K1's and K2's
    launches are read from its count file, as :func:`torchrun` reads each
    rank's. Returns (standard output, K1 launches, K2 forward launches, K2
    backward launches)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as count_dir:
        env = dict(os.environ, RANK="0", **{COUNT_DIR_ENV: count_dir})
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-rank", *args],
                           capture_output=True, text=True, timeout=timeout, env=env)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        with open(os.path.join(count_dir, "rank0")) as f:
            k1, k2, k2b = map(int, f.read().split())
        return p.stdout, k1, k2, k2b


def phase_orbax(dev, real, work, batch=256, num_compare=256, level_sizes=LEVEL_SIZES,
                bank_launches=432, fixtures=None):
    """The JAX package's Orbax checkpoints on the card, from the committed
    fixtures at full width:

    (a) the RN50 ``clip_0`` as a user loads it: the read of its params
        timed (MB/s), every leaf of both fixtures held to ``digests.json``;
        ``python -m hgr_tpu_torch --load True --load_path <fixture>`` over
        one batch of phase 9's decode cache, in a process of its own (K1
        builds the bank: ``bank_launches``); the fp32 image and text
        features of the seeded inputs, TF32 off, against JAX's;
    (b) the ResNet-50 ``_refit`` as ``--cnn``: ``load_backbone`` and the
        featurizer in fp32 against JAX's features;
    (c) ``--resume`` from the RN50 fixture for one OM step at ``batch``
        through ``driver.run_train`` (on a hierarchy of ``level_sizes``,
        whose 13 levels the fixture's ``layer_weight`` has): the loss
        finite, the step count going
        on from the fixture's, the update AdamW's on the carried moments,
        and its norm against a fresh AdamW step's on the same gradient.

    Returns K1's and K2's launches in (a)'s CLI run."""
    import hashlib
    import os
    import shutil
    from pathlib import Path

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.baselines.features import load_backbone, make_featurizer
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.models.clip import CLIP, encode_image, encode_text, get_config
    from hgr_tpu_torch.train import cosine_lr, init_train_state, make_optimizer
    from hgr_tpu_torch.utils.checkpoint import restore_checkpoint, restore_params
    from hgr_tpu_torch.utils.logging import RunLogger
    from hgr_tpu_torch.utils.orbax import read_leaves

    fixtures = Path(fixtures or Path(__file__).resolve().parent / "tests" / "torch_fixtures"
                    / "orbax")
    ckpt, refit = str(fixtures / "rn50" / "clip_0"), str(fixtures / "rn50_refit")
    digests = json.loads((fixtures / "digests.json").read_text())
    expected = np.load(fixtures / "expected.npz")

    # (a) the read, timed, and every leaf against JAX's digests
    t0 = time.time()
    params = read_leaves(ckpt, ("params",))
    read_s = time.time() - t0
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    log(f"[orbax] read params of {ckpt}: {len(params)} arrays, {nbytes / 1e6:.1f} MB decoded in "
        f"{read_s:.3f} s = {nbytes / 1e6 / read_s:.0f} MB/s (host: OCDBT, zarr, libzstd; tiled "
        f"fixture, so zstd's rate is above a trained checkpoint's) | {smi_name_power()}")
    del params
    for name in ("rn50/clip_0", "rn50_refit"):
        leaves = read_leaves(str(fixtures / name))
        got = {".".join(map(str, k)): leaf_digest(v) for k, v in leaves.items()
               if not isinstance(v, (type(None), tuple, list, dict))}
        bad = sorted(k for k in digests[name] if got.get(k) != digests[name][k])
        log(f"[orbax] {name}: {len(got)} leaves, {len(digests[name]) - len(bad)} of "
            f"{len(digests[name])} equal to JAX's digests")
        assert not bad and len(got) == len(digests[name]), bad[:5]
        del leaves

    # the CLI's --load on phase 9's files, one batch, K1's launches counted
    folder = os.path.join(work, "orbax_cli")
    cli = real["cfg_args"] + ["--load", "True", "--load_path", ckpt, "--max_test_batches", "1",
                              "--folder", folder, "--device", str(dev.index or 0)]
    t0 = time.time()
    _, launches, k2, k2b = cli_count(cli)
    cli_cfg = Config.from_args(cli)
    final = _final_eval(cli_cfg.save_path)
    k2_want = (-(-int(final["num_samples"]) // cli_cfg.test_batch_size)
               * rn_epilogues(real["tm"].clip_cfg))
    log(f"[orbax] CLI `python -m hgr_tpu_torch --load True --load_path {ckpt} ...` in "
        f"{time.time() - t0:.1f} s: K1 launches {launches}, K2 launches {k2} (want {k2_want}); "
        f"final {json.dumps(final)}")
    assert launches == bank_launches, f"K1 launched {launches} times, not {bank_launches}"
    assert k2 == k2_want and k2b == 0, f"K2 launched {k2} and {k2b} times, not {k2_want}, 0"
    assert final["num_samples"] > 0 and all(
        math.isfinite(v) for v in final.values() if isinstance(v, float)), final

    # fp32 features of the seeded inputs against JAX's, TF32 off
    cfg = get_config("RN50")
    images, tokens = orbax_inputs(cfg.image_resolution, cfg.context_length, cfg.vocab_size,
                                  **ORBAX_SEEDS)
    assert hashlib.sha256(images.tobytes()).hexdigest() == str(expected["images_sha256"])
    assert hashlib.sha256(tokens.tobytes()).hexdigest() == str(expected["tokens_sha256"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = CLIP(cfg).to(dev)
        model.load_state_dict(restore_params(ckpt, cfg)["clip"])
        model.eval()
        with torch.inference_mode():
            feats = {
                "image_feats": encode_image(model, torch.from_numpy(images).to(dev),
                                            dtype=torch.float32),
                "text_feats": encode_text(model, torch.from_numpy(tokens).to(dev).long(),
                                          dtype=torch.float32)}
        del model
        backbone = load_backbone(refit, device=dev)
        feats["resnet_feats"] = make_featurizer(backbone, crop=224, dtype=torch.float32)(images)
        del backbone
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for key, got in feats.items():
        want = expected[key]
        err = float(np.abs(got.float().cpu().numpy() - want).max() / np.abs(want).max())
        log(f"[orbax] {key} {tuple(want.shape)} fp32 on the card (TF32 off) against JAX's on "
            f"the CPU: largest difference {err:.2e} of the largest feature (tol "
            f"{ORBAX_FEAT_RTOL:g})")
        assert bool(torch.isfinite(got).all()) and err <= ORBAX_FEAT_RTOL, (key, err)

    # (c) --resume: one OM step from the fixture's optax state
    cfg = Config(arch="RN50", synthetic=True, train=True, remat=True, batch_size=batch,
                 num_compare=num_compare, epochs=2, n_episodes=1, resume=True, from_epoch=0,
                 test_after_train=False, synthetic_images_per_class=batch, print_freq=1,
                 folder=os.path.join(work, "orbax_resume"))
    shutil.copytree(ckpt, os.path.join(cfg.save_path, "clip_0"))
    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    splits = driver.synthetic_splits(hier, cfg.seed)
    tm = driver.build_model(cfg, hier, splits, device=dev)
    total = cfg.epochs * cfg.n_episodes
    before = init_train_state(CLIP(tm.clip_cfg).to(dev), torch.zeros_like(tm.layer_weight),
                              make_optimizer(cfg, total))
    restore_checkpoint(ckpt, before)
    assert before.step == ORBAX_STEP and before.opt_state.count == ORBAX_STEP
    logger = RunLogger(cfg.save_path, echo=False)
    t0 = time.time()
    after = driver.run_train(cfg, tm, splits, logger)
    wall = time.time() - t0
    losses = [r["loss"] for r in map(json.loads, open(logger.jsonl_path))
              if r["event"] == "train"]
    assert len(losses) == 1 and math.isfinite(losses[0]), losses
    assert after.step == ORBAX_STEP + 1 and after.opt_state.count == ORBAX_STEP + 1, after.step
    b1, b2 = after.opt_state.adamw.param_groups[0]["betas"]
    eps = after.opt_state.adamw.param_groups[0]["eps"]
    lr = cosine_lr(cfg.lr, cfg.warmup_length, total)
    bc1, bc2 = 1 - b1 ** (ORBAX_STEP + 1), 1 - b2 ** (ORBAX_STEP + 1)
    old = before.opt_state.adamw.state_dict()["state"]
    new = after.opt_state.adamw.state_dict()["state"]
    theta0 = list(before.params["clip"].state_dict().values())
    theta1 = list(after.params["clip"].state_dict().values())
    sq = {"actual": 0.0, "adamw": 0.0, "fresh": 0.0}
    for i, (t0_, t1_) in enumerate(zip(theta0, theta1)):
        m, v = new[i]["exp_avg"].float(), new[i]["exp_avg_sq"].float()
        g = (m - b1 * old[i]["exp_avg"].float()) / (1 - b1)  # the step's (clipped) gradient
        sq["actual"] += float(((t1_ - t0_).float() ** 2).sum())
        sq["adamw"] += float(((lr(ORBAX_STEP) / bc1 * m / (v.sqrt() / bc2 ** 0.5 + eps)) ** 2)
                             .sum())
        sq["fresh"] += float(((lr(0) * g / (g.abs() + eps)) ** 2).sum())
    norm = {k: v ** 0.5 for k, v in sq.items()}
    rel = abs(norm["actual"] - norm["adamw"]) / norm["adamw"]
    log(f"[orbax] --resume from {ckpt}: step {before.step} -> {after.step}, updates "
        f"{after.opt_state.count}, loss {losses[0]:.4f}, run_train {wall:.1f} s; update norm "
        f"{norm['actual']:.4e}, AdamW's on the carried moments {norm['adamw']:.4e} (off by "
        f"{rel:.2e}, tol {ORBAX_UPDATE_RTOL:g}); a fresh AdamW step on the same gradient "
        f"{norm['fresh']:.4e}: ratio {norm['actual'] / norm['fresh']:.4f}")
    assert rel <= ORBAX_UPDATE_RTOL, rel
    del tm, before, after
    shutil.rmtree(cfg.save_path, ignore_errors=True)
    shutil.rmtree(folder, ignore_errors=True)
    return launches, k2


def torchrun(args, nproc=MESH_WORLD, timeout=600, pred_dir=None):
    """``driver.main(args)`` in ``nproc`` ranks under ``python -m
    torch.distributed.run --standalone``, each through this script's
    ``--cli-rank`` mode (the CLI's entry point, with K1's and K2's launches
    counted; with ``pred_dir``, each rank's merged predictions saved there).
    Each rank writes its counts to a file of its own, since the ranks'
    standard outputs share one pipe and may interleave. Returns (standard
    output, each rank's K1 launches, each rank's K2 forward launches, each
    rank's K2 backward launches)."""
    import os
    import tempfile

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--cli-rank", *args]
    with tempfile.TemporaryDirectory() as count_dir:
        env = dict(os.environ, **{COUNT_DIR_ENV: count_dir},
                   **({PRED_DIR_ENV: pred_dir} if pred_dir else {}))
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        launches = {}
        for f in os.listdir(count_dir):
            with open(os.path.join(count_dir, f)) as fh:
                launches[int(f[len("rank"):])] = tuple(map(int, fh.read().split()))
    assert sorted(launches) == list(range(nproc)), (launches, p.stdout[-3000:])
    k1, k2, k2b = zip(*(launches[r] for r in range(nproc)))
    return p.stdout, list(k1), list(k2), list(k2b)


def cli_rank(argv):
    """One rank of :func:`torchrun`: ``python -m hgr_tpu_torch``'s
    ``driver.main`` with K1's and K2's (forward and backward) counts reset
    just before and read just after. Where ``$CHIP_SMOKE_PRED_DIR`` is set, a spy on the sharded eval keeps
    each batch's target and this rank's merged predictions
    (``ShardedEval.merged_preds``) and saves them there as ``rank{r}.pt``."""
    import os

    from hgr_tpu_torch import driver
    from hgr_tpu_torch.ops.attention import attention
    from hgr_tpu_torch.ops.bn_act import bn_act, bn_act_backward
    from hgr_tpu_torch.parallel.eval_spmd import ShardedEval

    pred_dir, seen = os.environ.get(PRED_DIR_ENV), []
    if pred_dir:
        real_merge, real_metrics = ShardedEval.merged_preds, ShardedEval.metrics_from_logits

        def metrics_spy(self, logits, target, valid=None):
            seen.append(dict(target=int(target)))
            return real_metrics(self, logits, target, valid)

        def merge_spy(self, logits):
            out = real_merge(self, logits)
            seen[-1].update(zip(("vals", "ids", "levels"), (x.cpu() for x in out)))
            return out

        ShardedEval.metrics_from_logits, ShardedEval.merged_preds = metrics_spy, merge_spy
    attention.launches = bn_act.launches = bn_act_backward.launches = 0
    driver.main(argv)
    rank = os.environ["RANK"]
    with open(os.path.join(os.environ[COUNT_DIR_ENV], f"rank{rank}"), "w") as f:
        f.write(f"{attention.launches} {bn_act.launches} {bn_act_backward.launches}")
    sys.stdout.write(f"[cli-rank {rank}] K1 launches {attention.launches}, K2 launches "
                     f"{bn_act.launches} forward, {bn_act_backward.launches} backward\n")
    sys.stdout.flush()
    if pred_dir:
        torch.save(seen, os.path.join(pred_dir, f"rank{os.environ['RANK']}.pt"))


def _counts(summary):
    """The summary's percentages as counts of images."""
    n = summary["num_samples"]
    return {k: summary[k] * n / 100.0 for k in ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20",
                                                 "tor", "path_ratio", "point_ratio")}


def one_process_preds(tm, cfg):
    """(a)'s reference, one process on the card: each batch of the run's
    split as the one-device path scores it (``encode_image``, ``bank_logits``
    against the whole sorted bank, ``TreeModel.metrics_from_logits``), with
    each image's test-masked top-maxk logits and ids (a stable sort: the
    lower column first on ties) and its per-level, then TOR, argmax. Yields
    (target, metrics, logits, top values, top ids, level ids, level maxima)."""
    from hgr_tpu_torch import driver
    from hgr_tpu_torch.data import GroupedTestLoader
    from hgr_tpu_torch.eval.bank import bank_logits
    from hgr_tpu_torch.eval.metrics import NEG, TOPK
    from hgr_tpu_torch.models.clip import encode_image
    from hgr_tpu_torch.ops.bank_topk import level_argmax_sorted

    hier, splits = driver.build_hierarchy(cfg)
    grouped = driver._grouped_split(cfg, cfg.data_split_test, splits[cfg.data_test], splits)
    src = driver._image_source(cfg, tm.clip_cfg.image_resolution, grouped, cfg.data_split_test)
    loader = GroupedTestLoader(grouped, {c: tm.hier.name_to_id[c] for c in grouped}, src,
                               cfg.test_batch_size, num_threads=cfg.num_workers)
    tb = tm._sorted_tables
    with torch.inference_mode():
        bank_s = tm.sort_bank(tm.update_classifier())
        try:
            for batch in loader:
                images = torch.from_numpy(batch.images).to(tm.device)
                valid = torch.from_numpy(batch.valid).to(tm.device)
                logits = bank_logits(encode_image(tm.model, images, dtype=tm.dtype), bank_s)
                masked = torch.where(tb["test_s"][None, :], logits, NEG)
                vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
                lev, lev_vals = level_argmax_sorted(logits, tm.level_offsets, tb["train_s"])
                yield (batch.target, tm.metrics_from_logits(logits, batch.target, valid), logits,
                       vals[:, :max(TOPK)], tb["order"][idx[:, :max(TOPK)]],
                       tb["order"][lev.long()], lev_vals)
        finally:
            loader.close()


def phase_mesh_eval(real, bank_launches=432):
    """(a) The CLI's eval of the real-input phase's weights (RN50, the
    18,278-class hierarchy padded to 18,432 bank rows, 4 batches of 512 from
    the decode cache), as 4 ranks on one card under ``torch.distributed.run``
    with ``--mesh_data 2 --mesh_model 2 --dist_backend gloo``, in a folder of
    its own and with ``--load_path`` at the ``clip_0`` that phase saved: each
    rank builds the bank (K1 432 times), takes its quarter of it and its half
    of each batch, and saves its merged predictions. Those are held image by
    image to one process's on the card: the top-20 test logits within
    ``MESH_VAL_ATOL``, and every top-1, level and TOR prediction equal or, in
    the one-process logits, within ``MESH_VAL_ATOL`` of the best; the counts
    to one process's, apart by at most the images whose predictions so
    differ. Returns each rank's K1 launches and each rank's K2 launches
    (``rn_epilogues`` for each batch's half it encodes)."""
    import os

    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.eval.metrics import FILL, NEG, accumulate, summarize

    tm, work = real["tm"], os.path.dirname(real["paths"]["runs"])
    folder, pred_dir = os.path.join(work, "mesh_runs"), os.path.join(work, "mesh_preds")
    os.makedirs(pred_dir)
    args = [*real["cfg_args"], "--folder", folder, "--load", "True",
            "--load_path", os.path.join(real["save_path"], "clip_0")]
    mesh = ["--mesh_data", "2", "--mesh_model", "2", "--dist_backend", "gloo"]
    t0 = time.time()
    _, launches, k2, k2b = torchrun(args + mesh, pred_dir=pred_dir)
    wall = time.time() - t0
    cfg = Config.from_args(args)
    finals = [r for r in map(json.loads, open(os.path.join(cfg.save_path, "metrics.jsonl")))
              if r["event"] == "eval" and r["tag"] == "final"]
    assert len(finals) == 1, finals
    got, want = finals[0], real["summary"]
    ranks = [torch.load(os.path.join(pred_dir, f"rank{r}.pt")) for r in range(MESH_WORLD)]
    # the ranks of a data row hold the same merged predictions
    for a, b in ((0, 1), (2, 3)):
        assert all(x["target"] == y["target"] and all(torch.equal(x[k], y[k]) for k in
                   ("vals", "ids", "levels")) for x, y in zip(ranks[a], ranks[b])), (a, b)

    order_inv = torch.argsort(tm._sorted_tables["order"])
    depth_s = torch.as_tensor(tm.node_depth, device=tm.device)[tm._sorted_tables["order"]]
    train_s, test_s = tm._sorted_tables["train_s"], tm._sorted_tables["test_s"]
    levels = list(range(tm.hier.max_depth + 1))
    total, n_img, val_err, exact, near, fill_slots = None, 0, 0.0, 0, 0, 0
    caught = {"halves swapped": 0, "rows shifted by one": 0}
    batches = list(one_process_preds(tm, cfg))
    assert len(batches) == len(ranks[0]), (len(batches), len(ranks[0]))
    k2_want = len(batches) * rn_epilogues(tm.clip_cfg)  # each rank encodes its half a batch
    for i, (target, m, logits, r_vals, r_ids, r_lev, r_lev_vals) in enumerate(batches):
        total = m if total is None else accumulate(total, m)
        d0, d1 = ranks[0][i], ranks[2][i]
        assert d0["target"] == d1["target"] == target, (i, d0["target"], target)
        vals = torch.cat([d0["vals"], d1["vals"]]).to(tm.device)
        ids = torch.cat([d0["ids"], d1["ids"]]).to(tm.device)
        lev = torch.cat([d0["levels"], d1["levels"]], dim=1).to(tm.device)
        n = logits.shape[0]
        n_img += n
        assert lev.shape == r_lev.shape, (lev.shape, r_lev.shape)
        real_v = r_vals > NEG / 2
        err = ((vals - r_vals).abs() * real_v).amax(dim=1)
        val_err = max(val_err, float(err.max()))
        for name, shift in (("halves swapped", n // 2), ("rows shifted by one", 1)):
            other = ((vals - r_vals.roll(shift, 0)).abs() * real_v).amax(dim=1)
            caught[name] += int((other > MESH_VAL_ATOL).sum())
        # a prediction that differs must tie the best within the tolerance
        rows = torch.arange(n, device=tm.device)
        pos = order_inv[ids[:, 0]]
        ok = (ids[:, 0] == r_ids[:, 0]) | (test_s[pos] & (logits[rows, pos]
                                                          >= r_vals[:, 0] - MESH_VAL_ATOL))
        same = ids[:, 0] == r_ids[:, 0]
        for j, lv in enumerate(levels + [-1]):
            pos = order_inv[lev[j]]
            in_slot = train_s[pos] & (depth_s[pos] == lv) if lv >= 0 else train_s[pos]
            beats_fill = r_lev_vals[j] > FILL
            fill_slots += int((~beats_fill).sum())
            mine = logits[rows, pos]
            ok &= ~beats_fill | (lev[j] == r_lev[j]) | (in_slot & (mine >= r_lev_vals[j]
                                                                    - MESH_VAL_ATOL))
            same &= ~beats_fill | (lev[j] == r_lev[j])
        assert bool(ok.all()), f"batch {i}: {int((~ok).sum())} images predicted apart"
        exact += int(same.sum())
        near += int((~same).sum())
    one = summarize(total)
    a, b, c = _counts(got), _counts(want), _counts(one)
    diff = max(abs(a[k] - b[k]) for k in b)
    log(f"[mesh-eval] CLI under torch.distributed.run, 4 gloo ranks on one card, mesh 2 x 2, "
        f"its own folder, --load_path clip_0: {wall:.1f} s of command; K1 launches by rank "
        f"{launches}, K2 launches by rank {k2} (want {k2_want} each); one final record")
    log(f"[mesh-eval] mesh: { {k: got[k] for k in want if k != 'imgs_per_sec'} }")
    log(f"[mesh-eval] one process: { {k: want[k] for k in want if k != 'imgs_per_sec'} }")
    log(f"[mesh-eval] image by image against one process ({n_img} images, {len(batches)} "
        f"batches): top-20 test logits apart by at most {val_err:.3e} (tol {MESH_VAL_ATOL:g}); "
        f"every prediction equal on {exact} images, tied within the tolerance on {near}; "
        f"{fill_slots} level slots below FILL not compared; against the same reference "
        f"{', '.join(f'{k}: {v} of {n_img} images over the tolerance' for k, v in caught.items())}")
    log(f"[mesh-eval] largest count difference {diff:.3f} images of {want['num_samples']:.0f} "
        f"(limit {near} + 1e-3, the images predicted apart and fp32 rounding); mesh {got['imgs_per_sec']:.0f} images/s "
        f"(rank 0's clock, bank build included)")
    assert got["num_samples"] == want["num_samples"] == n_img, (got, want, n_img)
    assert all(abs(b[k] - c[k]) < 1e-6 for k in b), (want, one)  # the reference is the run
    assert val_err <= MESH_VAL_ATOL, val_err
    assert all(v >= n_img // 2 for v in caught.values()), caught  # such faults would fail
    assert diff <= near + 1e-3, (got, want)  # path and point: fp32 sums in another order
    assert launches == [bank_launches] * MESH_WORLD, launches
    assert k2 == [k2_want] * MESH_WORLD and k2b == [0] * MESH_WORLD, (k2, k2b)
    return launches, k2


def _sharded_cases(tm, batch, seed):
    """(b)'s full-logit matrices [batch, N_pad] on the card: seeded normal
    logits; the same on a grid of step 1/4 (offset 1/8, so never exactly
    -1), where equal values fill every top-k; and level 5 sunk to -2 (the
    FILL case; the (., 4) meshes' boundary 13,824 lies inside level 5)."""
    g = torch.Generator(device=tm.device).manual_seed(seed)
    logits = torch.randn((batch, tm.n_pad), generator=g, device=tm.device)
    sunk = logits.clone()
    lo, hi = tm.level_offsets[5], tm.level_offsets[6]
    sunk[:, lo:hi] = -2.0
    return {"normal": logits, "ties": torch.round(logits * 4) / 4 + 0.125, "fill": sunk}


def merge_rank(rank, shapes, batch, seed, device="cuda:0", level_sizes=LEVEL_SIZES):
    """(b) on one rank: the sharded merge (``ShardedEval.metrics_from_logits``)
    of this rank's exact slice of each case, at each mesh, against the
    one-device metrics of the same logits (``TreeModel.metrics_from_logits``
    on each data slice, summed in data order). Returns, per mesh, case and
    target, whether the two are bitwise equal and the merged sums."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.eval.metrics import accumulate
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.parallel.eval_spmd import make_sharded_eval_step
    from hgr_tpu_torch.parallel.mesh import make_mesh
    from hgr_tpu_torch.tree_model import TreeModel

    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    tm = TreeModel.build(Config(arch="RN50"), hier, pad_multiple=1024, device=device)
    assert level_sizes != LEVEL_SIZES or (
        tm.n_pad == 18432 and tm.level_offsets[5] < 13824 < tm.level_offsets[6])
    targets = [int(tm.test_index[0]), int(hier.level(hier.max_depth)[0]),
               int(hier.level(3)[17]), int(hier.level(6)[0])]
    valid = torch.ones(batch, dtype=torch.bool, device=tm.device)
    valid[-12:] = False
    out = []
    for shape in shapes:
        mesh = make_mesh(*shape)
        step = make_sharded_eval_step(tm, mesh)
        rows, cols = batch // mesh.data, tm.n_pad // mesh.model
        d, m = mesh.data_index, mesh.model_index
        for name, logits in _sharded_cases(tm, batch, seed).items():
            for t in targets:
                got = step.metrics_from_logits(
                    logits[d * rows:(d + 1) * rows, m * cols:(m + 1) * cols], t,
                    valid[d * rows:(d + 1) * rows])
                want = None
                for i in range(mesh.data):
                    part = tm.metrics_from_logits(logits[i * rows:(i + 1) * rows], t,
                                                  valid[i * rows:(i + 1) * rows])
                    want = part if want is None else accumulate(want, part)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                out.append((shape, name, t, same, [x.tolist() for x in got]))
    return out


def phase_mesh_merge(shapes=((1, 4), (2, 2)), batch=512, seed=7, device="cuda:0",
                     level_sizes=LEVEL_SIZES):
    """(b) The merge, exactly: 4 gloo ranks on the card, each with its exact
    slice of one full-logit matrix at the real geometry (18,432 rows, shard
    boundaries inside levels), meshes (1, 4) and (2, 2); the merged
    BatchMetrics must equal the one-device metrics bit for bit, on every
    rank."""
    from hgr_tpu_torch.parallel.distributed import run_ranks

    t0 = time.time()
    ranks = run_ranks(merge_rank, MESH_WORLD, (shapes, batch, seed, device, level_sizes),
                      timeout_s=600)
    checked = len(ranks[0])
    bad = [(r, row[:3]) for r, rows in enumerate(ranks) for row in rows if not row[3]]
    agree = all([row[4] for row in rows] == [row[4] for row in ranks[0]] for rows in ranks)
    fill = [row for row in ranks[0] if row[1] == "fill"]
    log(f"[mesh-merge] meshes {list(shapes)}, cases normal / ties / fill x 4 targets, batch "
        f"{batch} (12 rows padding): {checked} merges a rank, bitwise equal to one device: "
        f"{not bad}, ranks agree: {agree}; {time.time() - t0:.1f} s with the start of 4 ranks")
    log(f"[mesh-merge] fill case, mesh {fill[-1][0]}, target {fill[-1][2]}: {fill[-1][4]}")
    assert not bad, bad
    assert agree


def phase_nccl(dev, tm, bank, batch=512):
    """(c) NCCL at world size 1 on the card: ``init_distributed(backend=
    "nccl")``, a 1 x 1 mesh whose two groups run every collective through
    NCCL, and the sharded step on one RN50 batch equal to
    ``eval_step_sorted`` bit for bit."""
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.eval_spmd import make_sharded_eval_step
    from hgr_tpu_torch.parallel.mesh import make_mesh

    assert distributed.init_distributed(f"localhost:{distributed._free_port()}", 1, 0,
                                        backend="nccl", timeout_s=120) == (0, 1)
    try:
        assert distributed.dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        bank_s = mesh.bank_shard(tm.sort_bank(bank))
        res = tm.clip_cfg.image_resolution
        gen = torch.Generator(device=dev).manual_seed(3)
        images = torch.randn((batch, res, res, 3), generator=gen, device=dev)
        valid = torch.ones(batch, dtype=torch.bool, device=dev)
        target = int(tm.test_index[0])
        got = make_sharded_eval_step(tm, mesh)(bank_s, images, target, valid)
        want = tm.eval_step_sorted(bank_s, images, target, valid)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[nccl] world 1 over NCCL, mesh 1 x 1: sharded step equal to eval_step_sorted bit "
            f"for bit: {same} ({[x.tolist() for x in got]})")
        assert same
    finally:
        distributed.dist.destroy_process_group()


def spmd_inputs(hier, train_index, cfg, steps, replicas, res, seed=0):
    """(d)'s inputs, the same in every process: per step, seeded uint8
    images [replicas, batch, res, res, 3] and the stacked schedules of one
    deepest-level class a replica (built in step-then-replica order)."""
    from hgr_tpu_torch.train import NegativeSampler, ScheduleBuilder
    from hgr_tpu_torch.train.spmd import stack_schedules

    rng = np.random.default_rng(seed)
    builder = ScheduleBuilder(hier, NegativeSampler(hier, train_index, cfg.num_compare, seed=seed),
                              cfg.out_ratio, cfg.in_ratio, cfg.num_compare)
    deep = hier.level(hier.max_depth)
    out = []
    for s in range(steps):
        images = rng.integers(0, 256, (replicas, cfg.batch_size, res, res, 3), dtype=np.uint8)
        scheds = [builder.build(int(deep[(s * replicas + r) * 7 % len(deep)]))
                  for r in range(replicas)]
        out.append((images, scheds, stack_schedules(scheds)))
    return out


def _fingerprint(params):
    """An exact fingerprint of the trained tensors: the sum of their bit
    patterns as integers (equal tensors give equal sums; a change in any
    bit changes the sum unless another cancels it)."""
    return int(sum(t.detach().contiguous().view(torch.int32).long().sum() for t in params))


def _spmd_setup(cfg, device, level_sizes):
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.tree_model import TreeModel

    hier = profiled_hierarchy(level_sizes, seed=0, cross_edges=40)
    tm = TreeModel.build(cfg, hier, pad_multiple=1024, device=device)
    tm.init_params(0)
    return hier, tm


def spmd_rank(rank, cfg, steps, grads_path, device="cuda:0", level_sizes=LEVEL_SIZES):
    """(d) on one rank: ``steps`` SPMD OM steps on mesh (2, 2). Returns the
    losses, the parameters' fingerprint after each step, each step's ms, the
    ms of each step's gradient all-reduce over the world and the numbers it
    sums, and the peak memory; rank 0 saves the gradient step 1's update
    applies."""
    from hgr_tpu_torch.parallel.mesh import make_mesh
    from hgr_tpu_torch.train import init_train_state, make_optimizer
    from hgr_tpu_torch.train import spmd
    from hgr_tpu_torch.train.spmd import make_spmd_train_step

    dev = torch.device(device)
    hier, tm = _spmd_setup(cfg, dev, level_sizes)
    mesh = make_mesh(2, 2)
    tx = make_optimizer(cfg, 10)
    state = init_train_state(tm.model, tm.layer_weight, tx)
    step = make_spmd_train_step(cfg, tx, mesh, dtype=tm.dtype)
    tokens = torch.as_tensor(tm.node_tokens, device=dev).long()
    inputs = spmd_inputs(hier, tm.train_index, cfg, steps, mesh.data,
                         tm.clip_cfg.image_resolution)
    # a spy on the path, not on what it computes: the gradients the first
    # update applies (summed over the world and scaled, before the clip)
    real_update, seen = tx.update, {}

    def update_spy(params, st):
        if not seen:
            g = tx.groups(params)
            seen["grads"] = [t.grad.detach().to("cpu", torch.float32, copy=True)
                             for t in g["clip"] + g["lw"]]
        return real_update(params, st)

    tx.update = update_spy
    # and a timer on the gradient all-reduce (synchronised on both sides, so
    # the backward's tail is not counted in it)
    real_sum, sum_ms, summed = spmd.all_sum_flat_, [], []

    def sum_spy(tensors, group, scale=None):
        _sync(dev)
        t0 = time.time()
        real_sum(tensors, group, scale=scale)
        _sync(dev)
        sum_ms.append((time.time() - t0) * 1e3)
        summed.append(sum(t.numel() for t in tensors))

    spmd.all_sum_flat_ = sum_spy
    _reset_peak(dev)
    losses, prints, ms = [], [], []
    for images, _, stacked in inputs:
        _sync(dev)
        t0 = time.time()
        state, loss = step(state, images, tokens, stacked)
        losses.append(float(loss))
        ms.append((time.time() - t0) * 1e3)
        g = tx.groups(state.params)
        prints.append(_fingerprint(g["clip"] + g["lw"]))
    if rank == 0:
        torch.save(seen["grads"], grads_path)
    return dict(losses=losses, prints=prints, ms=ms, sum_ms=sum_ms, summed=summed,
                peak=_peak_gib(dev))


def phase_mesh_train(dev, work, steps=2, batch=256, num_compare=256, arch="RN50",
                     level_sizes=LEVEL_SIZES):
    """(d) SPMD OM training: 4 gloo ranks on the card, mesh (2, 2), RN50 in
    bf16 with remat, batch 256 a replica, 256 negatives, ``steps`` steps:
    every rank's parameters bitwise equal after each step; step 1's loss
    against one process's mean of the two replica losses on the same
    batches, and the gradient that step's update applies against that
    process's mean gradient (cosine). Then ``python -m hgr_tpu_torch
    --train True`` with the mesh under ``torch.distributed.run``, 2 episodes
    (one step of 2 replicas; each rank's image tower, its block of the
    replica's batch, launches K2 forward and backward ``rn_epilogues``
    times, through its autograd Function). Returns each CLI rank's K1
    launches in it."""
    import os
    import shutil

    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.parallel.distributed import run_ranks
    from hgr_tpu_torch.train import freeze_params, make_om_loss_fn, make_optimizer, \
        sched_to_device

    cfg = Config(arch=arch, remat=True, batch_size=batch, num_compare=num_compare,
                 dtype="bfloat16" if dev.type == "cuda" else "float32")
    grads_path = os.path.join(work, "spmd_grads.pt")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_ranks(spmd_rank, MESH_WORLD, (cfg, steps, grads_path, str(dev), level_sizes),
                      timeout_s=900)
    wall = time.time() - t0
    for r, out in enumerate(ranks):
        log(f"[mesh-train] rank {r}: losses {out['losses']}, step ms "
            f"{[round(x, 1) for x in out['ms']]} (median {statistics.median(out['ms']):.1f}), "
            f"of which the gradient all-reduce of {out['summed'][0]:,} numbers "
            f"{[round(x, 1) for x in out['sum_ms']]}, peak memory {out['peak']:.2f} GiB, "
            f"fingerprints {out['prints']}")
    same = all(out["prints"] == ranks[0]["prints"] for out in ranks)
    assert same, [out["prints"] for out in ranks]
    assert len(set(ranks[0]["prints"])) == steps, "the parameters did not move"

    # one process: the mean of the two replica losses on step 1's batches
    hier, tm = _spmd_setup(cfg, dev, level_sizes)
    images, scheds, _ = spmd_inputs(hier, tm.train_index, cfg, 1, 2,
                                    tm.clip_cfg.image_resolution)[0]
    params = freeze_params({"clip": tm.model, "layer_weight": tm.layer_weight}, ())
    loss_fn = make_om_loss_fn(tm.dtype, cfg.training_method, cfg.weights, cfg.weighting,
                              remat=True)
    tokens = torch.as_tensor(tm.node_tokens, device=dev).long()
    loss = 0.0
    for r, sched in enumerate(scheds):
        part = loss_fn(params, torch.from_numpy(images[r]).to(dev), tokens,
                       sched_to_device(sched, dev)) / len(scheds)
        part.backward()
        loss += float(part.detach())
    g = make_optimizer(cfg, 10).groups(params)
    want = torch.cat([t.grad.detach().float().flatten() for t in g["clip"] + g["lw"]])
    got = torch.cat([x.flatten() for x in torch.load(grads_path)]).to(dev)
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    ratio = float(got.norm() / want.norm())
    rel = abs(ranks[0]["losses"][0] - loss) / abs(loss)
    log(f"[mesh-train] 4 ranks x {steps} steps in {wall:.1f} s with their start; parameters "
        f"bitwise equal on every rank after each step: {same}; step 1's loss "
        f"{ranks[0]['losses'][0]:.6f} against one process's mean of the replica losses "
        f"{loss:.6f} (rel {rel:.1e}, tol {SPMD_LOSS_RTOL:g}); the gradient step 1 applies, "
        f"cosine {cos:.6f} with one process's mean gradient (tol {SPMD_GRAD_COS}), norm ratio "
        f"{ratio:.6f} (tol 1 +- {SPMD_GRAD_NORM_RTOL:g}); on {_card_name(dev)}")
    assert rel <= SPMD_LOSS_RTOL and cos >= SPMD_GRAD_COS
    assert abs(ratio - 1) <= SPMD_GRAD_NORM_RTOL, ratio
    del tm, params, want, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    folder = os.path.join(work, "mesh_train")
    args = ["--synthetic", "True", "--arch", arch, "--train", "True", "--epochs", "1",
            "--n_episodes", "2", "--batch_size", str(batch), "--num_compare", str(num_compare),
            "--synthetic_images_per_class", str(batch), "--print_freq", "1", "--folder", folder,
            "--mesh_data", "2", "--mesh_model", "2", "--dist_backend", "gloo"]
    t0 = time.time()
    _, launches, k2, k2b = torchrun(args)
    save = Config.from_args(args).save_path
    records = [json.loads(line) for line in open(os.path.join(save, "metrics.jsonl"))]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    log(f"[mesh-train] CLI `python -m hgr_tpu_torch --train True --n_episodes 2 --mesh_data 2 "
        f"--mesh_model 2 --dist_backend gloo` under torch.distributed.run: {time.time() - t0:.1f} "
        f"s of command, rank 0 logged losses {losses}, wrote {sorted(os.listdir(save))}; K1 "
        f"launches by rank {launches} (the train step runs the plain attention), K2 forward "
        f"{k2} and backward {k2b} by rank (want {rn_epilogues_of(arch)} each: one step, its "
        f"autograd Function)")
    assert len(losses) == 1 and math.isfinite(losses[0])
    assert os.path.isdir(os.path.join(save, "clip_0")) and launches == [0] * MESH_WORLD
    assert k2 == k2b == [rn_epilogues_of(arch)] * MESH_WORLD, (k2, k2b)
    shutil.rmtree(folder, ignore_errors=True)
    return launches


def structure_xml(seed, n=160):
    """A seeded ImageNet ``structure_release.xml``: synsets under fall11 in
    a random tree, some under a second parent too (so edges repeat), then
    the misc subtree, whose food subtree n00021265 the builder re-attaches."""
    rng = np.random.default_rng(seed)
    kids = {i: [] for i in range(n)}
    for i in range(1, n):
        kids[int(rng.integers(0, i))].append(i)
    for i in rng.choice(np.arange(5, n), 12, replace=False):
        kids[int(rng.integers(0, 5))].append(int(i))

    def emit(i, depth):
        body = "".join(emit(c, depth + 1) for c in kids[i] if depth < 12)
        return f'<synset wnid="n{i:08d}">{body}</synset>'

    food = "".join(f'<synset wnid="f{j:07d}"/>' for j in range(4))
    misc = (f'<synset wnid="misc"><synset wnid="junk1"/><synset wnid="n00021265">{food}'
            f'</synset><synset wnid="junk2"/></synset>')
    return ('<ImageNetStructure><releaseData>fall2011</releaseData><synset wnid="fall11">'
            + "".join(emit(c, 1) for c in kids[0]) + misc + "</synset></ImageNetStructure>")


def builder_lists(seed, nodes):
    """Seeded official class lists and a winter list over ``nodes`` (the
    XML's synsets, sorted), with one wnid outside the graph."""
    rng = np.random.default_rng(seed + 100)

    def pick(k):
        return [nodes[i] for i in rng.choice(len(nodes), k, replace=False)]

    testsets = {"train": pick(20), "all": pick(60), "2-hops": pick(15), "3-hops": pick(25),
                "3-hops-pure": pick(10)}
    return testsets, pick(len(nodes) * 3 // 4) + ["n99999999"]


def write_builder_inputs(folder, seed=0):
    """``structure_release.xml``, ``testsets.json`` and ``winter.txt`` in
    ``folder``; returns the builder CLI's arguments."""
    import os
    import re

    xml = structure_xml(seed)
    nodes = sorted(set(re.findall(r'wnid="([^"]+)"', xml)) - {"fall11", "misc", "junk1", "junk2"})
    testsets, winter = builder_lists(seed, nodes)
    paths = {k: os.path.join(folder, f) for k, f in (
        ("xml", "structure_release.xml"), ("testsets", "testsets.json"), ("winter", "winter.txt"))}
    with open(paths["xml"], "w") as f:
        f.write(xml)
    with open(paths["testsets"], "w") as f:
        json.dump(testsets, f)
    with open(paths["winter"], "w") as f:
        f.write("\n".join(winter) + "\n")
    return ["--testsets", paths["testsets"], "--winter", paths["winter"], "--xml", paths["xml"],
            "--out", os.path.join(folder, "out"), "--no-strict"]


def phase_builder(work):
    """(e) ``python -m hgr_tpu_torch.hierarchy.builder`` on a seeded
    structure XML: its ``graph_edges_cls.json`` must be the JAX builder's
    (``EXPECTED_BUILDER_SHA256``)."""
    import hashlib
    import os

    folder = os.path.join(work, "builder")
    os.makedirs(folder)
    args = write_builder_inputs(folder)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "hgr_tpu_torch.hierarchy.builder", *args],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    path = os.path.join(folder, "out", "graph_edges_cls.json")
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    edges = json.load(open(path))
    log(f"[builder] CLI in {time.time() - t0:.1f} s: {len(edges)} edges, sha256 {digest[:16]}..., "
        f"equal to the JAX builder's: {digest == EXPECTED_BUILDER_SHA256}; "
        f"{p.stdout.strip().splitlines()[-1]}")
    assert digest == EXPECTED_BUILDER_SHA256


def main() -> int:
    import shutil
    import tempfile

    import os

    name = phase_device()
    phase_zstd()
    phase_build()
    from hgr_tpu_torch.device import select_device

    dev = select_device("cuda:0")
    n_procs = min(8, os.cpu_count() or 1)
    main_row = phase_kernels(dev)
    bn_act_row, bn_act_backward_row, k2_encodes, k2b_encodes = phase_bn_act(dev)
    ln_row, gelu_row = phase_ln_act(dev)
    phase_chains()
    tm, bank, summary, rn50, k2_rn50, k3_rn50 = phase_slice(dev)
    phase_plain_bank(tm, bank)
    fp32_bank = phase_fp32_bank(tm)
    phase_small_reference(tm, bank)
    phase_nccl(dev, tm, bank)
    del tm, bank
    vit, _, _, vit_launches, _, k3_vit = phase_slice(dev, arch="ViT-B/32", batches=2,
                                                     image_launches=12)
    phase_vit_features(vit)
    del vit
    vit16, _, _, vit16_launches, _, k3_vit16 = phase_slice(dev, arch="ViT-B/16", batches=1,
                                                           image_launches=12)
    phase_vit_features(vit16)
    k3_vit16_encode = phase_ln_features(vit16)
    del vit16
    rn50x4, k2_rn50x4, k3_rn50x4 = phase_slice(dev, arch="RN50x4", batches=1)[3:]
    work = tempfile.mkdtemp(prefix="hgr_real_inputs_")
    try:
        vit_l14, k3_vit_l14, k3_vit_l14_encode = phase_vit_l14(dev, work)
        eva02, k3_eva02, k3_eva02_encode, glu_row, rotary_row = phase_eva02_l14(dev)
        siglip, k3_siglip, k3_siglip_encode, _ = phase_siglip_so400m(dev)
        real = phase_real_inputs(dev, work, synthetic_ips=summary["imgs_per_sec"])
        serving = phase_files_and_serving(real)
        mesh_eval = phase_mesh_eval(real)
        orbax_load = phase_orbax(dev, real, work)
        real_launches, k2_real = real.pop("launches"), real.pop("k2")
        decoded = phase_decode(dev, real, n_procs)
        phase_baseline_images(dev, real, decoded, n_procs)
        phase_resnet_reference(dev)
        text = phase_export_text(dev, real)
        real.pop("tm")
        train = phase_train(dev)
        phase_trace(dev)
        accum = phase_train_accum(dev)
        phase_train_reference(dev)
        phase_guard(dev)
        coop = phase_coop(dev)
        flat = phase_flat(dev)
        # the real-input phase's hierarchy and splits
        clip_flat = phase_baselines(f"{work}/graph_edges_cls.json",
                                    f"{work}/splits_for_tree.json", dev.index or 0)
        phase_steps_reference(dev)
        phase_mesh_merge()
        mesh_train = phase_mesh_train(dev, work)
        phase_builder(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    by_path = {"rn50_eval": rn50, "rn50_fp32_bank": fp32_bank, "vit_b32_eval": vit_launches,
               "vit_b16_eval": vit16_launches,
               "rn50x4_eval": rn50x4,
               "vit_l14_eval": vit_l14,
               "eva02_l14_eval": eva02,
               "siglip_so400m_eval": siglip,
               "rn50_real_inputs_eval": real_launches,
               "rn50_orbax_load_eval": orbax_load[0],
               "rn50_files_num_proc_workers_eval": decoded["launches"],
               "export_text_feats": text,
               **({} if serving is None else {"rn50_serve_classify_files": serving[0]}),
               "rn50_train_steps": train["train_steps"], "rn50_test_after_train": train["test"],
               "rn50_accum_train_steps": accum[0],
               "rn50_coop_train_steps": coop["train_steps"],
               "rn50_coop_test_after_train": coop["test"],
               "rn50_flat_train_steps": flat["train_steps"],
               "rn50_flat_test_after_train": flat["test"],
               "test_rn_clip_flat_baseline_bank": clip_flat,
               "rn50_mesh_eval": sum(mesh_eval[0]), "rn50_mesh_train_steps": sum(mesh_train)}
    # K2's forward launches as each phase counted them (the mesh train's are asserted there)
    k2_by_path = {**k2_encodes, "rn50_eval": k2_rn50, "rn50x4_eval": k2_rn50x4,
                  "rn50_real_inputs_eval": k2_real, "rn50_orbax_load_eval": orbax_load[1],
                  "rn50_files_num_proc_workers_eval": decoded["k2"],
                  **({} if serving is None else {"rn50_serve_classify_files": serving[1]}),
                  "rn50_train_steps": train["k2_train_steps"],
                  "rn50_test_after_train": train["k2_test"],
                  "rn50_accum_train_steps": accum[1],
                  "rn50_coop_train_steps": coop["k2_train_steps"],
                  "rn50_coop_test_after_train": coop["k2_test"],
                  "rn50_flat_train_steps": flat["k2_train_steps"],
                  "rn50_flat_test_after_train": flat["k2_test"],
                  "rn50_mesh_eval": sum(mesh_eval[1])}
    # K2's backward launches: each train phase's (the mesh train's are asserted there)
    k2b_by_path = {**k2b_encodes,
                   "rn50_train_steps": train["k2b_train_steps"],
                   "rn50_accum_train_steps": accum[2],
                   "rn50_flat_train_steps": flat["k2b_train_steps"]}
    # K3's and the rotary's launches (``K3_NAMES``) as each phase counted them
    k3_by_path = {"rn50_eval": k3_rn50, "vit_b32_eval": k3_vit, "vit_b16_eval": k3_vit16,
                  "vit_b16_encode": k3_vit16_encode, "rn50x4_eval": k3_rn50x4,
                  "vit_l14_eval": k3_vit_l14, "vit_l14_encode": k3_vit_l14_encode,
                  "eva02_l14_eval": k3_eva02, "eva02_l14_encode": k3_eva02_encode,
                  "siglip_so400m_eval": k3_siglip, "siglip_so400m_encode": k3_siglip_encode,
                  "rn50_train_steps": train["k3_train_steps"],
                  "rn50_test_after_train": train["k3_test"],
                  "rn50_accum_train_steps": accum[3],
                  "rn50_coop_train_steps": coop["k3_train_steps"],
                  "rn50_coop_test_after_train": coop["k3_test"],
                  "rn50_flat_train_steps": flat["k3_train_steps"],
                  "rn50_flat_test_after_train": flat["k3_test"]}
    kernels = [dict(
        name="attention",
        route="cuda",
        source="hgr_tpu_torch/csrc/attention.cu",
        replaces="hgr_tpu/ops/attention.py:28",
        launches=sum(by_path.values()),
        launches_by_path=by_path,
        **main_row,
    ), dict(
        name="bn_act",
        route="cuda",
        source="hgr_tpu_torch/csrc/bn_act.cu",
        replaces="none (XLA fuses the ResNet's BatchNorm epilogues on the TPU)",
        launches=sum(k2_by_path.values()),
        launches_by_path=k2_by_path,
        **bn_act_row,
    ), dict(
        name="bn_act_backward",
        route="cuda",
        source="hgr_tpu_torch/csrc/bn_act.cu",
        replaces="none (XLA fuses the epilogues' backward on the TPU)",
        launches=sum(k2b_by_path.values()),
        launches_by_path=k2b_by_path,
        **bn_act_backward_row,
    )] + [dict(
        name=name,
        route="cuda",
        source="hgr_tpu_torch/csrc/rope.cu" if name == "rotary" else "hgr_tpu_torch/csrc/ln_act.cu",
        replaces="none (the JAX package has no EVA-02 tower)" if name == "rotary" else
                 "none (XLA fuses the transformer block's adds, LayerNorms and QuickGELU on "
                 "the TPU)",
        launches=sum(n[i] for n in k3_by_path.values()),
        launches_by_path={path: n[i] for path, n in k3_by_path.items()},
        **row,
    ) for i, (name, row) in enumerate(zip(K3_NAMES, (ln_row, gelu_row, glu_row, rotary_row)))]
    log(json.dumps({"kernels": kernels}))
    log(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # one rank of torchrun(), not a smoke run
        cli_rank(sys.argv[2:])
    else:
        sys.exit(main())
