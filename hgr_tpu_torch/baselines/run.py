"""Baseline runner CLI: train, then evaluate hierarchically, each baseline
family (port of ``hgr_tpu/baselines/run.py``).

    python -m hgr_tpu_torch.baselines.run --baseline cnzsl --synthetic True
    python -m hgr_tpu_torch.baselines.run --baseline gcn --variant dense_att ...
    python -m hgr_tpu_torch.baselines.run --baseline free ...
    python -m hgr_tpu_torch.baselines.run --baseline clip_flat --arch TEST-RN ...

One runner drives every family through the shared hierarchy and metric
engine, on ``cuda:{--device}`` (``device=`` from Python replaces it). With
no real inputs the frozen-backbone features are made up as class
prototypes (a linear map of the class embedding) plus noise, so that every
baseline has something real to learn. Real inputs: ``--attrs_path`` (a
``text_feats.json``, ``glove:<vectors.txt>`` or ``.npy``), ``--protos_path``
(``fc-weights.json``, a torch ResNet-50 checkpoint or ``.npy``),
``--feature_file`` and ``--train_feature_file`` (precomputed features),
``--image_root`` with ``--manifest`` and a frozen ResNet-50 (``--cnn``, a
torchvision checkpoint) that featurizes the test images, DGP's stage-A'
backbone refit over ``--train_manifest`` (``--refit_backbone``), and
CLIP-flat's ``--image_root`` with its manifests; ``--num_procs N`` decodes
images in N processes. ``--save_path`` writes the port's own
``torch.save`` artifacts (``utils/checkpoint.save_pytree``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import select_device


def build_eval_tables(hier, splits):
    """Padded arrays for the shared metric engine (as ``TreeModel.build``)."""
    n = hier.num_nodes
    train_mask = np.zeros(n, bool)
    train_mask[hier.ids(splits["all"])] = True
    test_mask = np.zeros(n, bool)
    test_mask[hier.ids(splits["rest"])] = True
    lmax = hier.max_chain + 1
    chains = np.full((n, lmax), -1, np.int32)
    chain_len = np.zeros(n, np.int32)
    for i in range(n):
        c = hier.chain_with_self(i)
        chains[i, : len(c)] = c
        chain_len[i] = len(c)
    return train_mask, test_mask, chains, chain_len


def load_attrs(path: str, hier, names_path: str = "") -> np.ndarray:
    """L2-normalised class embeddings in node order, from a
    ``text_feats.json`` (rows ``[[...]]``; the paper's "Tr" rows), GloVe
    vectors keyed by class name (``glove:<vectors.txt>``, names from
    ``names_path``; the "w2v" rows) or an [N, D] ``.npy``."""
    if path.startswith("glove:"):
        from .materials import GloVe, wnid_vectors

        names = {}
        if names_path:
            with open(names_path) as f:
                names = json.load(f)
        a = wnid_vectors(GloVe.from_txt(path[len("glove:"):]), list(hier.names), names)
    elif path.endswith(".json"):
        with open(path) as f:
            a = np.asarray([r[0] for r in json.load(f)], np.float32)
    else:
        a = np.load(path).astype(np.float32)
    if a.shape[0] != hier.num_nodes:
        raise ValueError(f"attrs rows {a.shape[0]} != hierarchy nodes {hier.num_nodes}")
    norm = np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    return (a / norm).astype(np.float32)


def load_protos(path: str) -> np.ndarray:
    """Per-class feature prototypes: ``fc-weights.json`` rows, a torch
    ResNet checkpoint's fc, or an [N, D] ``.npy`` (L2-normalised)."""
    if path.endswith(".json"):
        from .materials import fc_vectors_from_json

        return fc_vectors_from_json(path)
    if path.endswith((".pt", ".pth")):
        from .materials import fc_vectors_from_torch_resnet

        return fc_vectors_from_torch_resnet(path)
    p = np.load(path).astype(np.float32)
    return p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-12)


def synthetic_problem(hier, splits, feat_dim=64, attr_dim=32, seed=0):
    """Class embeddings and per-class feature prototypes with a learnable
    attr -> feature map."""
    rng = np.random.default_rng(seed)
    n = hier.num_nodes
    attrs = rng.standard_normal((n, attr_dim)).astype(np.float32)
    attrs /= np.linalg.norm(attrs, axis=1, keepdims=True)
    W = rng.standard_normal((attr_dim, feat_dim)).astype(np.float32) / np.sqrt(attr_dim)
    protos = attrs @ W
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    return attrs, protos


def sample_feats(protos, cls, batch, noise, rng):
    f = protos[cls][None, :] + noise * rng.standard_normal((batch, protos.shape[1])).astype(
        np.float32)
    return f.astype(np.float32)


EVAL_ROWS = 2048  # feature rows scored and counted in one pass
EVAL_IMAGES = 512  # CLIP-flat's test images through the image tower in one pass


@torch.no_grad()
def _evaluate(logit_fn, hier, splits, per_class, device):
    """The shared metric engine over ``per_class``, an iterable of (class
    id, numpy feature rows): the classes' rows go through ``logit_fn`` and
    ``grouped_metrics`` about ``EVAL_ROWS`` at a time. The JAX runner calls
    both once per batch of one class (``run.py:137-154``); the sums are the
    same, and thousands of calls would be bound by kernel launches."""
    from ..eval.metrics import accumulate, grouped_metrics, summarize, zeros_metrics

    train_mask, test_mask, chains, chain_len = build_eval_tables(hier, splits)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    train, test, depth = t(train_mask), t(test_mask), t(hier.depth.astype(np.int32))
    chains, chain_len = t(chains).long(), t(chain_len).long()
    def score(feats, ids):
        rows = t(np.repeat(ids, [len(f) for f in feats])).long()
        logits = torch.as_tensor(logit_fn(np.concatenate(feats)), device=device)
        return grouped_metrics(logits, rows, chains[rows], chain_len[rows], depth, train, test)

    total = zeros_metrics(device=device)
    feats, ids = [], []
    for c, f in per_class:
        feats.append(f)
        ids.append(c)
        if sum(len(x) for x in feats) >= EVAL_ROWS:
            total = accumulate(total, score(feats, ids))
            feats, ids = [], []
    if feats:
        total = accumulate(total, score(feats, ids))
    return summarize(total)


def evaluate_logit_model(logit_fn, hier, splits, protos, noise, batch, n_batches_per_class,
                         seed=0, device=None):
    """Grouped synthetic eval through the shared metric engine
    (``run.py:126-155``): ``n_batches_per_class`` batches of sampled
    features for every test class; ``logit_fn`` maps numpy features to
    logits on ``device``."""
    rng = np.random.default_rng(seed + 1)

    def per_class():
        for wnid in splits["rest"]:
            c = hier.name_to_id[wnid]
            yield c, np.concatenate([sample_feats(protos, c, batch, noise, rng)
                                     for _ in range(n_batches_per_class)])

    return _evaluate(logit_fn, hier, splits, per_class(), device)


def evaluate_real_images(logit_fn, hier, splits, grouped, proto_dim: int, feature_file=None,
                         device=None, image_root: str = "", featurizer=None, batch: int = 64,
                         resolution: int = 256, num_threads: int = 8, num_procs: int = 0):
    """Stage-B evaluation on real images (``evaluate_imagenet.py:65-152``):
    each class's features, the bias ones-column (``:85``), then the
    hierarchical metrics, every image of each class of ``grouped``. The
    features are ``feature_file``'s rows, or the test images under
    ``image_root`` through the frozen CNN (``featurizer``, ``:84``), decoded
    at ``resolution`` in batches of ``batch`` by threads or ``num_procs``
    processes."""
    from .features import with_bias_column

    if feature_file is not None:
        per_class = ((hier.name_to_id[cls], with_bias_column(feature_file.rows(cls), proto_dim))
                     for cls in grouped)
        return _evaluate(logit_fn, hier, splits, per_class, device)

    from ..data import FileImageSource, GroupedTestLoader

    loader = GroupedTestLoader(grouped, {c: hier.name_to_id[c] for c in grouped},
                               FileImageSource(resolution, image_root=image_root), batch,
                               num_threads=num_threads, num_procs=num_procs)

    def per_class():
        for b in loader:
            rows = featurizer(b.images)
            rows = rows[torch.as_tensor(b.valid, device=rows.device)]
            yield b.target, with_bias_column(rows.cpu().numpy(), proto_dim)

    try:
        return _evaluate(logit_fn, hier, splits, per_class(), device)
    finally:
        loader.close()


class TrainFeatureBank:
    """Real seen-class training features from a FeatureFile: the reference's
    regime, where CNZSL and FREE train on precomputed frozen-CNN features
    (``train_free.py:246-247``)."""

    def __init__(self, feature_file, seen_wnids):
        self.rows = [feature_file.rows(w) for w in seen_wnids]  # splits['train'] order
        self.dim = self.rows[0].shape[1]

    def sample(self, seen_positions, rng) -> np.ndarray:
        """One random stored row per requested seen-class position."""
        return np.stack([self.rows[p][int(rng.integers(self.rows[p].shape[0]))]
                         for p in seen_positions])

    def all_rows(self) -> np.ndarray:
        return np.concatenate(self.rows, axis=0)


def _seen_grouped(train_manifest_path: str, seen) -> dict:
    """Seen-class slice of a train manifest ({wnid: [paths]}); SystemExit when
    it holds no image of any seen class, a warning when it covers some."""
    with open(train_manifest_path) as f:
        manifest = json.load(f)
    grouped = {c: manifest[c] for c in seen if manifest.get(c)}
    if not sum(len(p) for p in grouped.values()):
        raise SystemExit(f"--train_manifest {train_manifest_path}: no images for any seen class")
    if len(grouped) != len(seen):
        missing = [c for c in seen if not manifest.get(c)]
        print(f"# WARNING: --train_manifest covers {len(grouped)}/{len(seen)} seen classes; "
              f"{len(missing)} absent (first 5: {missing[:5]}) — their frozen fc rows train "
              "on NO images", flush=True)
    return grouped


def _seen_train_loader(grouped_seen, seen, src, batch, seed, num_threads, num_procs):
    """A FlatTrainLoader whose labels index the ``seen`` order
    (splits['train']): the alignment of the clip_flat prompt bank and of the
    refit's predicted classifiers."""
    from ..data import FlatTrainLoader

    n_items = sum(len(p) for p in grouped_seen.values())
    return FlatTrainLoader(grouped_seen, {c: i for i, c in enumerate(seen)}, src,
                           max(1, min(batch, n_items)), seed=seed, num_threads=num_threads,
                           num_procs=num_procs)


def _test_grouped(manifest_path: str, rest) -> dict:
    """Test-class slice of an eval manifest; SystemExit when it shares no
    class with splits['rest']."""
    test_set = set(rest)
    with open(manifest_path) as f:
        manifest = json.load(f)
    grouped = {c: p for c, p in manifest.items() if c in test_set and p}
    if not grouped:
        raise SystemExit(
            f"--manifest {manifest_path}: none of its {len(manifest)} classes are in "
            f"splits['rest'] ({len(test_set)} wnids) — wrong manifest for this split?")
    return grouped


class _StepClock:
    """A training loop's wall time on the host clock, its first step (one-time
    costs: kernels' first launches, cuBLAS handles, the allocator) apart from
    the steady rate of the others; printed with the peak memory on the card."""

    def __init__(self, device):
        self.device = device
        self.t0 = self._now()
        self.t1 = None

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def step_done(self, i):
        if i == 0:
            self.t1 = self._now()

    def seconds(self):
        return self._now() - self.t0

    def report(self, name, steps):
        t2 = self._now()
        line = f"# {name}: {steps} steps in {t2 - self.t0:.2f} s"
        if self.t1 is not None and steps > 1:
            line += (f": the first {(self.t1 - self.t0) * 1e3:.1f} ms, then "
                     f"{(steps - 1) / max(t2 - self.t1, 1e-9):.2f} steps/s")
        else:
            line += f" = {steps / max(t2 - self.t0, 1e-9):.2f} steps/s"
        dev = self.device
        if dev.type == "cuda":
            line += (f" on {torch.cuda.get_device_name(dev)}, peak memory "
                     f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        print(line, flush=True)


def run_cnzsl(args, hier, splits, attrs, protos, train_bank=None, device=None):
    from .cnzsl import (CNZSLConfig, cnzsl_init, cnzsl_protos, cnzsl_scores,
                        make_cnzsl_train_step)
    from .optim import Adam

    proto_dim = train_bank.dim if train_bank is not None else protos.shape[1]
    cfg = CNZSLConfig(attr_dim=attrs.shape[1], proto_dim=proto_dim, hid_dim=args.hid_dim)
    params, state = cnzsl_init(torch.Generator().manual_seed(args.seed), cfg, device)
    tx = Adam(args.lr)
    opt = tx.init(params)
    step = make_cnzsl_train_step(cfg, tx)

    seen_ids = hier.ids(splits["train"])
    seen_attrs = torch.as_tensor(attrs[seen_ids], device=device)
    rng = np.random.default_rng(args.seed)
    clock = _StepClock(device)
    for i in range(args.steps):
        labels = rng.integers(0, len(seen_ids), args.batch)
        if train_bank is not None:
            feats = train_bank.sample(labels, rng)
        else:
            feats = np.stack([sample_feats(protos, int(seen_ids[x]), 1, args.noise, rng)[0]
                              for x in labels])
        params, state, opt, loss = step(params, state, opt, torch.as_tensor(feats, device=device),
                                        seen_attrs, torch.as_tensor(labels, device=device))
        if i % max(1, args.steps // 5) == 0:
            print(f"step {i}: loss {float(loss):.3f}", flush=True)
        clock.step_done(i)
    clock.report("cnzsl", args.steps)

    all_attrs = torch.as_tensor(attrs, device=device)
    if args.save_path:
        from ..utils.checkpoint import save_pytree

        save_pytree(args.save_path, {"params": params, "state": state})
        print(f"saved cnzsl params + stats -> {args.save_path}", flush=True)

    # eval mode reads the running statistics, so every class's prototype is
    # fixed: made once here, where the JAX logit_fn remakes all of them for
    # every batch (run.py:351-355)
    with torch.no_grad():
        protos_eval, _ = cnzsl_protos(params, state, all_attrs, cfg, training=False)

    def logit_fn(feats):
        return cnzsl_scores(torch.as_tensor(feats, device=device), protos_eval, cfg)

    return logit_fn


def run_gcn(args, hier, splits, attrs, protos, device=None):
    from .gcn import (Adjacency, GCNConfig, basic_edges, dense_edges, gcn_apply, gcn_init,
                      make_gcn_train_step)
    from .optim import Adam

    n = hier.num_nodes
    if args.variant == "basic":
        adj = [Adjacency.build(basic_edges(hier), n, device=device)]
        r_adj = None
        mode, hops = "basic", 1
    else:
        groups = dense_edges(hier, max_hops=4)
        adj = [Adjacency.build(g, n, device=device) for g in groups]
        r_adj = [Adjacency.build(g, n, transpose=True, device=device) for g in groups]
        mode = "dense_att" if args.variant == "dense_att" else "dense"
        hops = len(groups)
        if mode == "dense":
            adj, r_adj = adj[:1], r_adj[:1]
    cfg = GCNConfig(n=n, in_channels=attrs.shape[1], out_channels=protos.shape[1],
                    hidden_layers=str(args.hid_dim), mode=mode, n_hops=hops)
    params = gcn_init(torch.Generator().manual_seed(args.seed), cfg, device)
    tx = Adam(args.lr)
    opt = tx.init(params)
    step = make_gcn_train_step(cfg, tx, adj, r_adj)

    seen_ids = torch.as_tensor(hier.ids(splits["train"]).astype(np.int64), device=device)
    fc_vectors = torch.as_tensor(protos, device=device)  # already normalised
    x = torch.as_tensor(attrs, device=device)
    clock = _StepClock(device)
    for i in range(args.steps):
        # the JAX runner passes no dropout key (run.py:399): no dropout
        params, opt, loss = step(params, opt, x, fc_vectors, seen_ids, None)
        if i % max(1, args.steps // 5) == 0:
            print(f"epoch {i}: loss {float(loss):.5f}", flush=True)
        clock.step_done(i)
    clock.report(f"gcn {args.variant}", args.steps)

    with torch.no_grad():
        pred = gcn_apply(params, cfg, x, adj, r_adj)  # [N, D] normalised
    if args.save_path:
        from ..utils.checkpoint import save_pytree

        save_pytree(args.save_path, {"params": params, "pred": pred})
        print(f"saved gcn params + pred -> {args.save_path}", flush=True)

    def logit_fn(feats):
        f = torch.as_tensor(feats, device=device)
        return (f / torch.linalg.norm(f, dim=1, keepdim=True)) @ pred.T

    # the stage-A' refit reads the predicted classifiers off the scorer
    logit_fn.pred = pred.float().cpu().numpy()
    return logit_fn


def run_free(args, hier, splits, attrs, protos, train_bank=None, device=None):
    from .free import (FREEConfig, draw_d, draw_g, free_init, make_free_steps, other_labels,
                       synthesize_features, train_softmax_classifier)

    seen_ids = hier.ids(splits["train"])
    # the sigmoid generator's features live in [0, 1]: min-max scaled by the
    # real training features, else by the prototypes (classifier.py)
    if train_bank is not None:
        allr = train_bank.all_rows()
        fmin, fmax = float(allr.min()), float(allr.max())
        res_size = train_bank.dim
    else:
        fmin, fmax = float(protos.min()), float(protos.max())
        res_size = protos.shape[1]
    span = max(fmax - fmin, 1e-12)
    protos01 = None if train_bank is not None else (protos - fmin) / span
    cfg = FREEConfig(res_size=res_size, att_size=attrs.shape[1], latent_size=attrs.shape[1],
                     ngh=4 * res_size, ndh=4 * res_size, nclass_seen=len(seen_ids),
                     center_margin=20.0, syn_num=args.syn_num)
    params = free_init(torch.Generator().manual_seed(args.seed), cfg, device)
    d_step, g_step, init_opts = make_free_steps(cfg)
    optD, optFR, optC, optEG = init_opts(params)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    rng = np.random.default_rng(args.seed)

    lambda1 = cfg.lambda1
    clock = _StepClock(device)
    for i in range(args.steps):
        labels = rng.integers(0, len(seen_ids), args.batch)
        if train_bank is not None:
            feats = np.clip((train_bank.sample(labels, rng) - fmin) / span, 0, 1)
        else:
            feats = np.stack([np.clip(protos01[seen_ids[x]]
                                      + args.noise * rng.standard_normal(res_size), 0, 1)
                              for x in labels])
        att = torch.as_tensor(attrs[seen_ids[labels]], device=device)
        featt = torch.as_tensor(feats.astype(np.float32), device=device)
        labt = torch.as_tensor(labels, device=device)
        gp_sum = 0.0
        for _ in range(cfg.critic_iter):
            draws = draw_d(g, cfg, args.batch, len(seen_ids))
            others = other_labels(labt, len(seen_ids), draws["offsets"])
            params, optD, optFR, optC, d_cost, wass, gp = d_step(
                params, optD, optFR, optC, featt, att, labt, others, lambda1, draws)
            gp_sum += float(gp) * lambda1 * cfg.gammaD
        # adaptive GP weight (the reference's train_free.py:330-334)
        gp_sum /= cfg.gammaD * lambda1 * cfg.critic_iter
        if gp_sum > 1.05:
            lambda1 *= 1.1
        elif gp_sum < 1.001:
            lambda1 /= 1.1
        params, optEG, g_loss = g_step(params, optEG, featt, att, draw_g(g, cfg, args.batch))
        if i % max(1, args.steps // 5) == 0:
            print(f"step {i}: D {float(d_cost):.3f} G {float(g_loss):.3f} "
                  f"lambda1 {lambda1:.2f}", flush=True)
        clock.step_done(i)
    clock.report(f"free ({cfg.critic_iter} critic steps a step)", args.steps)

    # features for ALL classes, then a softmax over the full set
    all_attrs = torch.as_tensor(attrs, device=device)
    z = torch.randn((all_attrs.shape[0], args.syn_num, cfg.latent_size), generator=g,
                    device=g.device)
    syn, syn_labels = synthesize_features(params, cfg, all_attrs, args.syn_num, z)
    clock = _StepClock(device)
    clf = train_softmax_classifier(syn, syn_labels, hier.num_nodes, lr=args.lr, epochs=3,
                                   batch=min(512, syn.shape[0]), generator=g)
    clock.report(f"free softmax classifier over {syn.shape[0]} synthesized features",
                 3 * (syn.shape[0] // min(512, syn.shape[0])))
    del syn, syn_labels

    if args.save_path:
        from ..utils.checkpoint import save_pytree

        save_pytree(args.save_path, {"params": params, "classifier": clf})
        print(f"saved free params + classifier -> {args.save_path}", flush=True)

    def logit_fn(feats):
        # evaluation features take the training's 0-1 mapping
        f01 = np.clip((feats - fmin) / span, 0, 1).astype(np.float32)
        return torch.as_tensor(f01, device=device) @ clf["w"] + clf["b"]

    return logit_fn


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("hgr_tpu_torch baselines")
    ap.add_argument("--baseline", required=True, choices=["cnzsl", "gcn", "free", "clip_flat"])
    ap.add_argument("--variant", default="dense_att", choices=["basic", "dense", "dense_att"])
    ap.add_argument("--synthetic", type=lambda s: s.lower() == "true", default=True)
    ap.add_argument("--graph_path", default="")
    ap.add_argument("--split_path", default="")
    ap.add_argument("--attrs_path", default="", help=(
        "class embeddings: text_feats.json (Tr), glove:<vectors.txt> (w2v), or .npy; "
        "default synthetic"))
    ap.add_argument("--protos_path", default="", help=(
        "class prototypes: fc-weights.json, torch resnet .pt/.pth, or .npy; default derived "
        "from attrs"))
    ap.add_argument("--names_path", default="", help="wnid->name json for glove:")
    ap.add_argument("--save_path", default="", help=(
        "save trained baseline artifacts (the port's torch.save tree): gcn -> params + "
        "predicted classifiers, cnzsl -> params + standardization stats, free -> params + "
        "classifier"))
    ap.add_argument("--tr_concat", action="store_true", help=(
        "apply the reference's Tr preprocessing cat((f,f,ones)) + normalize"))
    ap.add_argument("--consider_trains", type=lambda s: s.lower() == "true", default=True,
                    help="False = the DGP scripts' ZSL protocol: seen-class logits set to 1e-7")
    ap.add_argument("--image_root", default="", help=(
        "evaluate on REAL images: root of the on-disk image tree; requires --manifest + --cnn"))
    ap.add_argument("--manifest", default="", help=(
        "grouped eval manifest json: wnid -> [relative image paths]; classes outside "
        "splits['rest'] are ignored"))
    ap.add_argument("--cnn", default="", help=(
        "frozen feature backbone: a torchvision ResNet-50 .pt/.pth, or a save_pytree "
        "directory (e.g. a {save_path}_refit)"))
    ap.add_argument("--feature_file", default="", help=(
        "precomputed per-class eval features (.npz wnid -> [n_i, D]) - skips the CNN"))
    ap.add_argument("--train_feature_file", default="", help=(
        "precomputed SEEN-class features for cnzsl/free TRAINING (same .npz format); "
        "requires real eval inputs too"))
    ap.add_argument("--train_manifest", default="", help=(
        "SEEN-class training manifest json: wnid -> [relative image paths]; consumed by "
        "--refit_backbone and by clip_flat real-image training"))
    ap.add_argument("--refit_backbone", action="store_true", help=(
        "DGP stage-A' (gcn only): refit the --cnn base on --train_manifest's seen-class "
        "images under the GCN-predicted classifier, then evaluate through it"))
    ap.add_argument("--refit_steps", type=int, default=100)
    ap.add_argument("--refit_lr", type=float, default=1e-4)
    ap.add_argument("--refit_batch", type=int, default=64)
    ap.add_argument("--eval_resolution", type=int, default=256, help=(
        "loader resolution for real-image eval and the refit (short-side resize + centre "
        "crop); the featurizer centre-crops --eval_crop out of it"))
    ap.add_argument("--eval_crop", type=int, default=224)
    ap.add_argument("--num_threads", type=int, default=8)
    ap.add_argument("--num_procs", type=int, default=0, help="decode images in N processes")
    ap.add_argument("--feat_dim", type=int, default=64)
    ap.add_argument("--attr_dim", type=int, default=32)
    ap.add_argument("--hid_dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval_batch", type=int, default=16)
    ap.add_argument("--eval_batches_per_class", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.15)
    ap.add_argument("--syn_num", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="TEST-RN")
    ap.add_argument("--device", type=int, default=0, help="runs on cuda:{device}")
    return ap


def _hierarchy(args):
    from ..hierarchy import Hierarchy, synthetic_hierarchy

    if args.synthetic or not args.graph_path:
        hier = synthetic_hierarchy(3, 4, 5, args.seed)
        rng = np.random.default_rng(args.seed)
        names = list(hier.names)
        perm = rng.permutation(len(names))
        n_train = len(names) * 2 // 3
        splits = {"train": [names[i] for i in sorted(perm[:n_train])],
                  "rest": [names[i] for i in sorted(perm[n_train:])]}
        splits["all"] = splits["train"] + splits["rest"]
        return hier, splits
    with open(args.split_path) as f:
        return Hierarchy.from_json(args.graph_path), json.load(f)


def main(argv=None, device=None):
    """``python -m hgr_tpu_torch.baselines.run [flags]``; returns the
    summary dict. ``device`` (from Python only) replaces ``cuda:{--device}``."""
    args = _parser().parse_args(argv)
    dev = select_device(device, args.device)
    hier, splits = _hierarchy(args)

    if args.refit_backbone and args.baseline != "gcn":
        # before the clip_flat dispatch: every baseline refuses the flag
        raise SystemExit("--refit_backbone is the DGP stage-A' flow (--baseline gcn)")
    if args.baseline == "clip_flat":
        return run_clip_flat(args, hier, splits, device=dev)

    attrs = load_attrs(args.attrs_path, hier, args.names_path) if args.attrs_path else None
    protos = load_protos(args.protos_path) if args.protos_path else None
    if protos is not None and protos.shape[0] != hier.num_nodes:
        raise ValueError(f"protos rows {protos.shape[0]} != hierarchy nodes {hier.num_nodes}")
    if attrs is None and protos is None:
        attrs, protos = synthetic_problem(hier, splits, args.feat_dim, args.attr_dim, args.seed)
    elif protos is None:
        # real embeddings, no real prototypes: learnable prototypes made from
        # the embeddings, as the synthetic problem makes them
        rng = np.random.default_rng(args.seed)
        w = rng.standard_normal((attrs.shape[1], args.feat_dim)).astype(
            np.float32) / np.sqrt(attrs.shape[1])
        protos = attrs @ w
        protos /= np.maximum(np.linalg.norm(protos, axis=1, keepdims=True), 1e-12)
    elif attrs is None:
        attrs, _ = synthetic_problem(hier, splits, args.feat_dim, args.attr_dim, args.seed)
    if args.tr_concat:
        from .materials import tr_word_vectors

        attrs = tr_word_vectors(attrs)
    train_bank = None
    if args.train_feature_file:
        if args.baseline not in ("cnzsl", "free"):
            raise SystemExit("--train_feature_file applies to cnzsl/free "
                             "(gcn regresses to prototypes, not features)")
        if not (args.image_root or args.feature_file):
            raise SystemExit("--train_feature_file trains in the real feature space; "
                             "evaluation needs real inputs too (--image_root/--feature_file)")
        from .features import FeatureFile

        train_bank = TrainFeatureBank(FeatureFile(args.train_feature_file), splits["train"])
    # flag contracts and manifests are checked before any training: a
    # mistake fails in seconds
    refit_grouped_seen = None
    if args.refit_backbone:
        if not (args.cnn and args.image_root and args.train_manifest):
            raise SystemExit("--refit_backbone needs --cnn + --image_root "
                             "+ --train_manifest (seen-class images)")
        if args.feature_file:
            raise SystemExit("--feature_file holds features from the UN-refit backbone; "
                             "--refit_backbone evaluates through the refit CNN "
                             "(drop --feature_file)")
        if args.refit_steps < 1:
            raise SystemExit(f"--refit_steps {args.refit_steps}: must be >= 1 "
                             "(drop --refit_backbone to skip stage-A')")
        refit_grouped_seen = _seen_grouped(args.train_manifest, splits["train"])
    eval_grouped = None
    if args.image_root or args.feature_file:
        if not args.manifest:
            raise SystemExit("--image_root/--feature_file requires --manifest")
        if not (args.feature_file or args.cnn):
            raise SystemExit("--image_root requires --cnn (or use --feature_file)")
        eval_grouped = _test_grouped(args.manifest, splits["rest"])

    if args.baseline == "cnzsl":
        logit_fn = run_cnzsl(args, hier, splits, attrs, protos, train_bank, device=dev)
    elif args.baseline == "free":
        logit_fn = run_free(args, hier, splits, attrs, protos, train_bank, device=dev)
    else:
        logit_fn = run_gcn(args, hier, splits, attrs, protos, device=dev)

    refit_model = None
    if args.refit_backbone:
        refit_model = run_refit(args, hier, splits, logit_fn.pred, refit_grouped_seen, dev)

    if not args.consider_trains:
        # the DGP scripts' ZSL protocol: seen-class columns set to a
        # reachable 1e-7, not excluded (evaluate_21kp.py:93-95)
        from .materials import suppress_seen

        seen_mask = np.zeros(hier.num_nodes, bool)
        seen_mask[hier.ids(splits["train"])] = True
        base_fn = logit_fn

        def logit_fn(feats):  # noqa: F811 - a deliberate wrap
            return suppress_seen(base_fn(feats), seen_mask)

    t0 = time.time()
    if eval_grouped is not None:
        from .features import FeatureFile, load_backbone, make_featurizer

        feature_file = featurizer = None
        if args.feature_file:
            feature_file = FeatureFile(args.feature_file)
            feat_dim = feature_file.dim
        else:
            # the refit backbone when there is one (stage B after stage A')
            model = refit_model if refit_model is not None else load_backbone(args.cnn, dev)
            featurizer = make_featurizer(model, crop=args.eval_crop)
            feat_dim = 2048
        # the ones column follows the logit model's input width: GCN
        # classifiers live in proto space (possibly D + 1, DGP's 2049),
        # cnzsl/free trained on a real bank take its feature width
        logit_dim = train_bank.dim if train_bank is not None else protos.shape[1]
        if logit_dim not in (feat_dim, feat_dim + 1):
            raise SystemExit(
                f"real-image eval produces {feat_dim}-d features but the "
                f"{args.baseline} model expects {logit_dim}-d inputs — train in the real "
                "feature space (--protos_path from a real backbone for gcn; "
                "--train_feature_file for cnzsl/free)")
        clock = _StepClock(dev)
        summary = evaluate_real_images(logit_fn, hier, splits, eval_grouped, logit_dim,
                                       feature_file, device=dev, image_root=args.image_root,
                                       featurizer=featurizer, batch=args.eval_batch,
                                       resolution=args.eval_resolution,
                                       num_threads=args.num_threads, num_procs=args.num_procs)
        if featurizer is not None:
            secs = clock.seconds()
            print(f"# featurizer: {int(summary['num_samples'])} test images in {secs:.2f} s = "
                  f"{summary['num_samples'] / max(secs, 1e-9):.1f} images/s, decode and "
                  f"metrics included ({args.num_procs} decode processes)", flush=True)
    else:
        summary = evaluate_logit_model(logit_fn, hier, splits, protos, args.noise,
                                       args.eval_batch, args.eval_batches_per_class, args.seed,
                                       device=dev)
    print(f"# eval over {int(summary['num_samples'])} samples in {time.time() - t0:.2f} s",
          flush=True)
    return _finish(args.baseline, summary)


def run_refit(args, hier, splits, pred, grouped_seen, device):
    """DGP stage A' (``train_resnet_fit.py:43-101``; JAX ``run.py:714-751``):
    the ``--cnn`` base retrains under the GCN-predicted classifiers of the
    seen classes, on their images; returns the refit model, which stage B
    then featurizes with. With ``--save_path`` it and the trlog go to
    ``{save_path}_refit``."""
    from ..data import FileImageSource
    from .features import load_backbone
    from .refit import refit_backbone

    seen = splits["train"]
    # labels index rows of pred[seen]: the alignment the reference asserts
    # against its train dir (train_resnet_fit.py:43)
    loader = _seen_train_loader(grouped_seen, seen,
                                FileImageSource(args.eval_resolution, image_root=args.image_root),
                                args.refit_batch, args.seed, args.num_threads, args.num_procs)
    clock = _StepClock(device)
    marked = _MarkedLoader(loader, clock)
    try:
        model, trlog = refit_backbone(load_backbone(args.cnn, device), pred[hier.ids(seen)],
                                      marked, steps=args.refit_steps, lr=args.refit_lr,
                                      crop=args.eval_crop, seed=args.seed,
                                      log_every=max(1, args.refit_steps // 5))
    finally:
        loader.close()
    clock.report(f"refit, batch {loader.batch_size}", args.refit_steps)
    gaps = np.diff(marked.marks) * 1e3
    if len(gaps):
        print(f"# refit: median step {np.median(gaps):.1f} ms after the first "
              f"({len(gaps)} steps; loader wait included)", flush=True)
    print(f"refit done: loss {trlog['loss'][-1]:.4f} acc {trlog['acc'][-1]:.4f}", flush=True)
    if args.save_path:
        # the reference's per-epoch resnet_base checkpoints and trlog
        # history (train_resnet_fit.py:94-100), one artifact here
        from ..utils.checkpoint import save_pytree

        save_pytree(args.save_path + "_refit", {"params": model.state_dict(), "trlog": trlog})
        print(f"saved refit backbone + trlog -> {args.save_path}_refit", flush=True)
    return model


class _MarkedLoader:
    """A train loader that reads the step clock after each batch's step
    (the next batch is asked for once the step ran, its loss read):
    ``marks`` holds the times."""

    def __init__(self, loader, clock):
        self.loader, self.clock, self.marks = loader, clock, []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            yield batch
            self.clock.step_done(len(self.marks))
            self.marks.append(self.clock._now())


def _finish(baseline, summary):
    from ..utils.logging import format_report

    print(format_report(summary), flush=True)
    print(json.dumps({"baseline": baseline, **summary}), flush=True)
    return summary


def run_clip_flat(args, hier, splits, device=None):
    """CLIP flat fine-tune, then the shared eval (``run.py:813-938``).

    Synthetic images by default; with ``--image_root``, ``--train_manifest``
    and ``--manifest`` it trains on real seen-class batches and evaluates on
    real test images through the standard loaders, the reference's flow
    (``baseline/CLIP/clip_train.py:205-223`` train, ``:89-203`` eval). A
    partial set of real inputs is refused."""
    from ..config import Config
    from ..eval.metrics import accumulate, summarize, zeros_metrics
    from ..ops.attention import attention
    from ..tree_model import TreeModel
    from .clip_flat import make_flat_train_step
    from .optim import OPTAX_ADAMW_DECAY, Adam

    real = bool(args.image_root or args.manifest or args.train_manifest)
    if real and not (args.image_root and args.manifest and args.train_manifest):
        raise SystemExit(
            "clip_flat real-image mode needs ALL of --image_root, --manifest (test classes) "
            "and --train_manifest (seen classes); got a partial set — refusing to silently "
            "train on synthetic images")
    if args.feature_file or args.train_feature_file:
        raise SystemExit("clip_flat featurizes with its own CLIP encoders; "
                         "--feature_file/--train_feature_file do not apply")

    cfg = Config(arch=args.arch, dtype="float32")
    # rows padded to the bank's chunk of 512: the JAX runner's 64 fails the
    # JAX bank's own divisibility check once there are more than 512 classes
    tm = TreeModel.build(cfg, hier, candidates_train=splits["all"],
                         candidates_test=splits["rest"], pad_multiple=512, seed=args.seed,
                         device=device)
    tm.init_params(args.seed)
    seen = splits["train"]
    seen_ids = hier.ids(seen)
    seen_tokens = torch.as_tensor(tm.node_tokens[seen_ids], device=device).long()
    params = {"clip": tm.model}
    tx = Adam(args.lr, weight_decay=OPTAX_ADAMW_DECAY)  # optax.adamw(lr) (run.py:853)
    opt = tx.init(params)
    step = make_flat_train_step(tx, dtype=torch.float32)
    rng = np.random.default_rng(args.seed)
    res = tm.clip_cfg.image_resolution

    src = train_loader = None
    if real:
        from ..data import FileImageSource

        src = FileImageSource(res, image_root=args.image_root)
        train_loader = _seen_train_loader(_seen_grouped(args.train_manifest, seen), seen, src,
                                          args.batch, args.seed, args.num_threads, args.num_procs)
        batches = iter(train_loader)
    clock = _StepClock(device)
    try:
        epoch = 0
        for i in range(args.steps):
            if real:
                try:
                    images, labels, _valid = next(batches)
                except StopIteration:
                    epoch += 1
                    train_loader.set_epoch(epoch)
                    batches = iter(train_loader)
                    images, labels, _valid = next(batches)
            else:
                labels = rng.integers(0, len(seen_ids), args.batch)
                images = rng.standard_normal((args.batch, res, res, 3)).astype(np.float32)
            params, opt, loss = step(params, opt, torch.as_tensor(images, device=device),
                                     seen_tokens, torch.as_tensor(labels, device=device))
            if i % max(1, args.steps // 5) == 0:
                print(f"step {i}: loss {float(loss):.3f}", flush=True)
            clock.step_done(i)
    finally:
        if train_loader is not None:
            train_loader.close()
    clock.report(f"clip_flat {args.arch}, {len(seen_ids)} seen prompts a step", args.steps)

    t0 = time.time()
    launches = attention.launches
    bank_s = tm.sort_bank(tm.update_classifier())
    print(f"# K1 launches in the bank: {attention.launches - launches}", flush=True)
    total = zeros_metrics(device=device)
    if real:
        from ..data import GroupedTestLoader

        grouped = _test_grouped(args.manifest, splits["rest"])
        loader = GroupedTestLoader(grouped, {c: hier.name_to_id[c] for c in grouped}, src,
                                   args.eval_batch, num_threads=args.num_threads,
                                   num_procs=args.num_procs)
        try:
            for b in loader:
                total = accumulate(total, tm.eval_step_sorted(
                    bank_s, torch.as_tensor(b.images, device=device), b.target,
                    valid=torch.as_tensor(b.valid, device=device)))
        finally:
            loader.close()
    else:
        # the image tower over the batches of many classes at once, each
        # class's batch then scored on its own (run.py:924-932 makes one
        # eval step a class; the draws are the same, in the same order)
        from ..models.clip import encode_image

        rest = splits["rest"]
        per_pass = max(1, EVAL_IMAGES // args.eval_batch)
        for lo in range(0, len(rest), per_pass):
            wnids = rest[lo: lo + per_pass]
            images = np.concatenate([rng.standard_normal((args.eval_batch, res, res, 3))
                                     for _ in wnids]).astype(np.float32)
            with torch.inference_mode():
                feats = encode_image(tm.model, torch.as_tensor(images, device=device),
                                     dtype=tm.dtype)
            for k, wnid in enumerate(wnids):
                total = accumulate(total, tm.metrics_sorted(
                    bank_s, feats[k * args.eval_batch: (k + 1) * args.eval_batch],
                    hier.name_to_id[wnid]))
    summary = summarize(total)
    print(f"# eval over {int(summary['num_samples'])} samples in {time.time() - t0:.2f} s",
          flush=True)
    return _finish("clip_flat", summary)


if __name__ == "__main__":
    main()
