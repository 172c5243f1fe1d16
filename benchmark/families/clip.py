"""OpenAI's CLIP (``github.com/openai/CLIP``, ``clip/model.py``): the modified
ResNet with its attention pool or the ViT (pre-LN blocks, a fused
``in_proj``, a 4 x width QuickGELU MLP), beside the causal text tower.

The family of every configuration without a ``"family"`` key. Its
functions are ``hbench/reference.py``'s and ``hbench/work.py``'s, which
pick the ResNet or the ViT by ``vision.patch_size`` (0 for the ResNet).
"""

import json

from hbench.reference import draw_weights, encode_image, encode_text  # noqa: F401
from hbench.work import image_flops, text_attention_work, text_flops  # noqa: F401
from hbench.work import vit_attention_work


def image_attention_work(cfg, images):
    """K1 runs in the ViT tower only; the ResNet's attention pool is one
    query's plain attention."""
    return vit_attention_work(cfg, images) if cfg["vision"]["patch_size"] else None


def tiny(cfg):
    """``cfg`` at the program's TEST sizes: TEST-ViT for a ViT, TEST-RN for
    the ResNet; a 2-layer text tower 32 wide over 512 ids; the class set of
    five levels."""
    cfg = json.loads(json.dumps(cfg))
    cfg["classes"] = {"level_sizes": [3, 12, 30, 40, 20], "hierarchy_seed": 0, "cross_edges": 0,
                      "n_seen": 70, "pad_multiple": 128}
    cfg["text"] = {"context_length": 77, "vocab_size": 512, "width": 32, "heads": 2, "layers": 2}
    cfg["embed_dim"] = 64
    if cfg["vision"]["patch_size"]:
        cfg["arch"] = "TEST-ViT"
        cfg["vision"] = {"layers": 2, "width": 64, "patch_size": 8, "image_resolution": 32}
    else:
        cfg["arch"] = "TEST-RN"
        cfg["vision"] = {"layers": [1, 1, 1, 1], "width": 16, "patch_size": 0,
                         "image_resolution": 32}
    return cfg
