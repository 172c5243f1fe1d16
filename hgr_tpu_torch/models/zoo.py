"""Model zoo: the reference's ``clip.available_models()`` / ``clip.load``
surface (``clip/clip.py:25-185``) without downloads (port of
``hgr_tpu/models/zoo.py``).

``load`` reads a local OpenAI checkpoint (``models/convert.py``) or draws
random weights from an explicit ``torch.Generator``; the sha256 digests of
the official checkpoints are kept so that a local file can be verified.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import torch

from ..device import select_device
from .clip import CLIP, CONFIGS, CLIPConfig, clip_init, get_config

# sha256 of the official OpenAI checkpoint files, from their published URLs
# (clip/clip.py:25-32 embeds these digests in the URL path); the JAX
# package's set, which has no ViT-L/14 digest, so ``verify_checkpoint``
# refuses every ViT-L/14 file
OFFICIAL_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
}


def available_models() -> List[str]:
    """Names of the architectures the port runs (reference ``clip/clip.py:35``)."""
    return [k for k in CONFIGS if not k.startswith("TEST")]


def verify_checkpoint(path: str, name: str) -> bool:
    """sha256-check a local checkpoint against the official digest."""
    want = OFFICIAL_SHA256.get(name)
    if want is None:
        return False
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == want


def load(
    name: str,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    verify: bool = False,
    device=None,
) -> Tuple[CLIPConfig, CLIP]:
    """-> (config, CLIP in eval mode on ``device``, default ``cuda:0``). With
    ``checkpoint``, the file's weights and the architecture read from them;
    otherwise ``name``'s architecture with random weights from ``seed``."""
    dev = select_device(device)
    if checkpoint:
        if verify and not verify_checkpoint(checkpoint, name):
            raise ValueError(
                f"checkpoint {checkpoint} does not match the official {name} sha256")
        from .convert import load_torch_checkpoint

        cfg, sd = load_torch_checkpoint(checkpoint)
        model = CLIP(cfg)
        model.load_state_dict(sd)
        return cfg, model.to(dev).eval()
    cfg = get_config(name)
    return cfg, clip_init(cfg, torch.Generator().manual_seed(seed), dev).eval()
