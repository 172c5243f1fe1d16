#!/usr/bin/env python
"""Export per-class CLIP text features (``text_feats.json``) with the
PyTorch port: the counterpart of ``tools/export_text_feats.py``.

The reference's baselines read ``text_feats.json`` (one CLIP text feature a
class; ``baseline/DGP/train_gcn_basic_tran.py:50``, ``baseline/FREE/
train_free.py:242``, ``baseline/CNZSL/cnzsl.py:183``) and ship no producer.
This tool encodes every node's prompt through the port's text tower (on the
card, through the fused attention kernel) and writes one L2-normalised row
a class, in hierarchy node order, for ``baselines/run.py --attrs_path``.

Usage:
  python tools/export_torch_text_feats.py --graph_path graph_edges_cls.json \\
      --arch RN50 [--ckpt openai.pt] [--names_path names.json] \\
      [--vocab_path merges.txt.gz] [--out text_feats.json] [--synthetic] [--device 0]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, device=None):
    """Returns the path written; ``device`` (from Python only) replaces
    ``cuda:{--device}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph_path", default="")
    ap.add_argument("--arch", default="RN50")
    ap.add_argument("--ckpt", default="", help="OpenAI CLIP .pt to load (default: seeded weights)")
    ap.add_argument("--names_path", default="")
    ap.add_argument("--template", default="TEMPLATES_SIMPLE")
    ap.add_argument("--vocab_path", default="")
    ap.add_argument("--out", default="text_feats.json")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--device", type=int, default=0, help="runs on cuda:{device}")
    args = ap.parse_args(argv)

    import numpy as np

    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.device import select_device
    from hgr_tpu_torch.hierarchy import Hierarchy, synthetic_hierarchy
    from hgr_tpu_torch.tree_model import TreeModel

    dev = select_device(device, args.device)
    if args.synthetic or not args.graph_path:
        hier = synthetic_hierarchy(3, 4, 5, 0)
    else:
        hier = Hierarchy.from_json(args.graph_path)
    tokenizer = names = None
    if not args.synthetic:
        from hgr_tpu_torch.text import Tokenizer

        try:
            tokenizer = Tokenizer(args.vocab_path or None)
        except FileNotFoundError:
            pass
        if args.names_path and os.path.exists(args.names_path):
            with open(args.names_path) as f:
                names = json.load(f)
    config = Config(arch=args.arch, template=args.template, vocab_path=args.vocab_path)
    tm = TreeModel.build(config, hier, tokenizer=tokenizer, names=names,
                         pad_multiple=args.chunk, device=dev)
    if args.ckpt:
        tm.load_torch(args.ckpt)
    else:
        tm.init_params(0)
    feats = tm.update_classifier()[: hier.num_nodes].float().cpu().numpy().astype(np.float32)
    with open(args.out, "w") as f:
        json.dump([[row.tolist()] for row in feats], f)
    print(f"wrote {feats.shape} features for {hier.num_nodes} classes -> {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
