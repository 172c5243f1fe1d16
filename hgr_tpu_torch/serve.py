"""Serving API: batched zero-shot classification against the class bank
(port of ``hgr_tpu/serve.py``).

Build the class bank once, then classify image batches: flat top-k labels
with cosine scores, and the hierarchical root-path prediction through the
same depth-sorted one-pass argmax the evaluator uses.

    clf = ZeroShotClassifier(tm)           # tm: a built TreeModel with weights
    clf.refresh_bank()                     # re-encode prompts (e.g. after training)
    ids, scores = clf.classify(images, k=5)
    paths = clf.predict_paths(images)      # [B, n_levels] global node ids
    wnids = clf.classify_files(paths_on_disk, k=5)

On the card the bank build, and a ViT image tower, run the fused attention
kernel. ``classify_files`` decodes files in a thread pool
(``FileImageSource``) or, with ``num_procs > 0``, in worker processes
(``data/mp_decode.py``); the CLI is ``python -m hgr_tpu_torch.serve IMG ...``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .eval.bank import bank_logits
from .eval.metrics import NEG
from .models.clip import encode_image
from .ops.bank_topk import level_argmax_sorted


def topk_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, columns) of the k largest entries of each row, in
    ``lax.top_k``'s order: descending, the lower column first on ties, the
    order ``eval/metrics.py:_rank_hits`` counts. ``torch.topk`` promises no
    order among equal values; a stable descending sort keeps it."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class ZeroShotClassifier:
    """Batched zero-shot inference over a TreeModel's class bank.

    ``candidates``: "test" restricts predictions to unseen classes (the
    reference's zero-shot protocol), "train" to candidate classes, "all" to
    every real node.
    """

    def __init__(self, tm, candidates: str = "all"):
        self.tm = tm
        n = tm.hier.num_nodes
        real = np.zeros(tm.n_pad, bool)
        real[:n] = True
        mask = {
            "all": real,
            "test": tm.test_mask & real,
            "train": tm.train_mask & real,
        }[candidates]
        dev = tm.device
        self._mask_sorted = torch.as_tensor(mask[tm.depth_order], device=dev)
        self._order = torch.as_tensor(tm.depth_order, device=dev).long()
        self._train_sorted = torch.as_tensor(tm.train_mask[tm.depth_order], device=dev)
        self.bank_sorted: Optional[torch.Tensor] = None

    def refresh_bank(self) -> None:
        """(Re-)encode all node prompts into the depth-sorted bank."""
        self.bank_sorted = self.tm.sort_bank(self.tm.update_classifier())

    def _logits(self, images) -> torch.Tensor:
        if self.bank_sorted is None:
            self.refresh_bank()
        images = torch.as_tensor(images, device=self.tm.device)
        feats = encode_image(self.tm.model, images, dtype=self.tm.dtype)
        return bank_logits(feats, self.bank_sorted)

    @torch.inference_mode()
    def classify(self, images, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """[B, H, W, 3] images -> (node ids [B, k] int32, cosine scores
        [B, k] float32)."""
        masked = torch.where(self._mask_sorted[None, :], self._logits(images), NEG)
        vals, idx = topk_lower_first(masked, k)
        ids = self._order[idx].to(torch.int32)
        return ids.cpu().numpy(), vals.cpu().numpy()

    @torch.inference_mode()
    def predict_paths(self, images) -> np.ndarray:
        """Per-level constrained argmax -> [B, n_levels] global node ids (the
        hierarchical prediction the POR/path metrics score). Serving shows
        the best in-level node per level; the metrics' -1 fill rule only
        turns matches into misses and never gives a better node."""
        preds_s, _ = level_argmax_sorted(self._logits(images), self.tm.level_offsets,
                                         self._train_sorted)
        paths = self._order[preds_s.long()][:-1].T  # drop the TOR slot
        return paths.to(torch.int32).cpu().numpy()

    def classify_files(self, paths: Sequence[str], k: int = 5, batch: int = 64,
                       image_root: str = "", num_threads: int = 8,
                       num_procs: int = 0) -> List[List[Tuple[str, float]]]:
        """Decode files (native JPEG decoder, else PIL) in ``num_threads``
        threads or, with ``num_procs > 0``, in that many processes (the
        loaders' ``--num_proc_workers`` path, for many-core serving hosts),
        and classify; returns per-image ``[(wnid, score), ...]`` lists. A
        file that fails to decode raises: serving has no class whose first
        image could stand in."""
        from concurrent.futures import ThreadPoolExecutor

        from .data import FileImageSource
        from .data.pipeline import _maybe_mp_pool

        src = FileImageSource(self.tm.clip_cfg.image_resolution, image_root)
        mp_pool = _maybe_mp_pool(src, num_procs, batch)
        names = self.tm.hier.names
        out: List[List[Tuple[str, float]]] = []
        try:
            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                for s in range(0, len(paths), batch):
                    chunk = list(paths[s: s + batch])
                    if mp_pool is not None:  # a file falls back to itself: it raises
                        arr = mp_pool.decode_pairs([(p, p) for p in chunk])
                    else:
                        arr = np.stack(list(pool.map(lambda p: src.load("", [p], 0), chunk)))
                    # raw uint8 rows: encode_image normalises them on the device
                    ids, vals = self.classify(arr, k)
                    out.extend([(names[int(i)], float(v)) for i, v in zip(row_ids, row_vals)]
                               for row_ids, row_vals in zip(ids, vals))
        finally:
            if mp_pool is not None:
                mp_pool.close()
        return out


def main(argv=None, device=None) -> None:
    """``python -m hgr_tpu_torch.serve IMG [IMG ...] [flags]``
    (``hgr_tpu/serve.py:161-223``).

    The serving flags are parsed here and every other flag goes to
    :class:`~hgr_tpu_torch.config.Config`, so model and checkpoint selection
    work as in ``python -m hgr_tpu_torch`` (``--arch``, ``--graph_path``,
    ``--load --load_path`` / ``--from_epoch``, ``--synthetic True`` for a
    weightless smoke run, ...). Prints one JSON line per image:
    ``{"image": ..., "topk": [{"wnid", "name", "score"}, ...]}``. ``device``
    (from Python only) replaces ``cuda:{--device}``.
    """
    import argparse
    import json
    import os

    from .config import Config
    from .driver import build_hierarchy, build_model

    parser = argparse.ArgumentParser(
        "hgr_tpu_torch.serve",
        description="Zero-shot classify image files against the class bank.",
    )
    parser.add_argument("images", nargs="+", help="image files to classify")
    parser.add_argument("--k", type=int, default=5, help="top-k to emit")
    parser.add_argument(
        "--candidates", default="all", choices=["all", "test", "train"],
        help="restrict predictions (the reference ZSL protocol uses 'test')",
    )
    parser.add_argument("--image_root", default="", dest="serve_image_root",
                        help="prefix joined to relative image paths")
    parser.add_argument("--num_procs", type=int, default=0, dest="serve_num_procs",
                        help="decode in N worker processes")
    ns, rest = parser.parse_known_args(argv)

    config = Config.from_args(rest)
    hier, splits = build_hierarchy(config)
    tm = build_model(config, hier, splits, device=device)
    clf = ZeroShotClassifier(tm, candidates=ns.candidates)
    clf.refresh_bank()
    names = None
    if config.names_path and os.path.exists(config.names_path):
        with open(config.names_path) as f:
            names = json.load(f)
    results = clf.classify_files(ns.images, k=ns.k, image_root=ns.serve_image_root,
                                 num_procs=ns.serve_num_procs)
    for path, topk in zip(ns.images, results):
        print(json.dumps({
            "image": path,
            "topk": [
                {"wnid": w, **({"name": names[w]} if names and w in names else {}),
                 "score": round(s, 4)}
                for w, s in topk
            ],
        }), flush=True)


if __name__ == "__main__":
    main()
