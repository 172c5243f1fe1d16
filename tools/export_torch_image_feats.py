#!/usr/bin/env python
"""Export per-class frozen-CNN image features (``features.npz``) with the
PyTorch port: the counterpart of ``tools/export_image_feats.py``.

The reference re-featurizes every eval batch through the frozen ResNet-50
on every run (``baseline/DGP/evaluate_imagenet.py:84``), and its CNZSL/FREE
stages read precomputed per-class feature matrices that it ships no
producer for. This tool featurizes a grouped manifest once (uint8 loader,
centre crop, ImageNet normalisation, ResNet-50 in bf16 on the card) and
writes an ``.npz`` of wnid -> [n_i, 2048] rows that ``baselines/run.py
--feature_file`` and the CNZSL/FREE training paths read back.

Usage:
  python tools/export_torch_image_feats.py --manifest test_split.json \\
      --image_root /data/imagenet --cnn resnet50.pth --out features.npz \\
      [--resolution 256 --crop 224 --batch 64 --num_procs 8 --device 0]
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
    ap.add_argument("--manifest", required=True, help="grouped json: wnid -> [relative paths]")
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--cnn", required=True,
                    help="torchvision ResNet-50 .pt/.pth, or a save_pytree directory")
    ap.add_argument("--out", default="features.npz")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num_threads", type=int, default=8)
    ap.add_argument("--num_procs", type=int, default=0)
    ap.add_argument("--classes", default="", help="optional json list limiting the classes")
    ap.add_argument("--device", type=int, default=0, help="runs on cuda:{device}")
    args = ap.parse_args(argv)

    from hgr_tpu_torch.baselines.features import export_image_features, load_backbone
    from hgr_tpu_torch.device import select_device

    dev = select_device(device, args.device)
    with open(args.manifest) as f:
        grouped = {c: p for c, p in json.load(f).items() if p}
    if args.classes:
        with open(args.classes) as f:
            keep = set(json.load(f))
        grouped = {c: p for c, p in grouped.items() if c in keep}
    out = export_image_features(grouped, args.image_root, load_backbone(args.cnn, dev), args.out,
                                resolution=args.resolution, crop=args.crop, batch=args.batch,
                                num_threads=args.num_threads, num_procs=args.num_procs)
    n = sum(len(p) for p in grouped.values())
    print(f"wrote {n} features for {len(grouped)} classes -> {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
