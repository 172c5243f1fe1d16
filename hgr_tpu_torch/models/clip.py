"""CLIP container: both towers and the logit scale (port of
``hgr_tpu/models/clip.py``).

``CLIP`` carries OpenAI's ``state_dict`` names, so a checkpoint's keys map
one to one. ``clip_init`` draws every parameter from an explicit
``torch.Generator`` with the distributions of the JAX ``*_init`` functions
(not their bits). ``encode_image`` takes NHWC images, raw uint8 or float,
as the JAX function does. The image tower is the modified ResNet or, when
``vision_patch_size > 0``, the ViT; only the ViT takes ``attn_fn`` and
``remat``, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import attention
from .layers import Embedding, LayerNorm, _param, l2_normalize, normal_
from .resnet import ModifiedResNet
from .text_encoder import text_encoder_apply
from .transformer import Transformer
from .vit import VisionTransformer


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 1024
    # vision
    image_resolution: int = 224
    vision_layers: Tuple[int, ...] = (3, 4, 6, 3)
    vision_width: int = 64
    vision_patch_size: int = 0  # 0 => ResNet, >0 => ViT
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size > 0

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64


# The zoo (hyperparameters of the public OpenAI checkpoints,
# hgr_tpu/models/clip.py:55-115) and the tiny configurations the tests use.
CONFIGS: Dict[str, CLIPConfig] = {
    "RN50": CLIPConfig(),
    "RN101": CLIPConfig(embed_dim=512, vision_layers=(3, 4, 23, 3), transformer_width=512),
    "RN50x4": CLIPConfig(
        embed_dim=640,
        image_resolution=288,
        vision_layers=(4, 6, 10, 6),
        vision_width=80,
        transformer_width=640,
        transformer_heads=10,
    ),
    "RN50x16": CLIPConfig(
        embed_dim=768,
        image_resolution=384,
        vision_layers=(6, 8, 18, 8),
        vision_width=96,
        transformer_width=768,
        transformer_heads=12,
    ),
    "ViT-B/32": CLIPConfig(
        embed_dim=512,
        vision_layers=(12,),
        vision_width=768,
        vision_patch_size=32,
        transformer_width=512,
    ),
    "ViT-B/16": CLIPConfig(
        embed_dim=512,
        vision_layers=(12,),
        vision_width=768,
        vision_patch_size=16,
        transformer_width=512,
    ),
    "TEST-RN": CLIPConfig(
        embed_dim=64,
        image_resolution=32,
        vision_layers=(1, 1, 1, 1),
        vision_width=16,
        context_length=77,
        vocab_size=512,
        transformer_width=32,
        transformer_heads=2,
        transformer_layers=2,
    ),
    "TEST-ViT": CLIPConfig(
        embed_dim=64,
        image_resolution=32,
        vision_layers=(2,),
        vision_width=64,
        vision_patch_size=8,
        context_length=77,
        vocab_size=512,
        transformer_width=32,
        transformer_heads=2,
        transformer_layers=2,
    ),
}


def get_config(name: str) -> CLIPConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(CONFIGS)}") from None


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.is_vit:
            self.visual = VisionTransformer(
                cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
                cfg.vision_layers[0], cfg.vision_heads, cfg.embed_dim,
            )
        else:
            self.visual = ModifiedResNet(
                cfg.vision_layers, cfg.embed_dim, cfg.vision_heads,
                cfg.image_resolution, cfg.vision_width,
            )
        w = cfg.transformer_width
        self.transformer = Transformer(w, cfg.transformer_layers, cfg.transformer_heads)
        self.token_embedding = Embedding(cfg.vocab_size, w)
        self.positional_embedding = _param(cfg.context_length, w)
        self.ln_final = LayerNorm(w)
        self.text_projection = _param(w, cfg.embed_dim)
        self.logit_scale = _param(())


def clip_init(
    cfg: CLIPConfig, generator: torch.Generator, device=None
) -> CLIP:
    """A ``CLIP`` with random weights drawn on the CPU from ``generator``
    (the JAX ``clip_init`` distributions), then moved to ``device``."""
    m = CLIP(cfg)
    m.visual.init(generator)
    normal_(m.token_embedding.weight, 0.02, generator)
    normal_(m.positional_embedding, 0.01, generator)
    m.transformer.init(generator)
    m.ln_final.init()
    normal_(m.text_projection, cfg.transformer_width ** -0.5, generator)
    with torch.no_grad():
        m.logit_scale.fill_(math.log(1.0 / 0.07))  # clip/model.py:291
    return m.to(device) if device is not None else m


# CLIP preprocessing constants (reference clip/clip.py:76-77); used by the
# on-device normalisation of raw-uint8 batches.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def encode_image(
    m: CLIP,
    images: torch.Tensor,  # [B, H, W, 3] pre-normalised float, or raw uint8
    dtype: torch.dtype = torch.bfloat16,
    attn_fn=attention,
    remat: bool = False,
) -> torch.Tensor:
    if images.dtype == torch.uint8:
        # raw uint8 edge: normalise on the device in fp32, then cast
        mean = torch.tensor(CLIP_MEAN, device=images.device) * 255.0
        scale = 1.0 / (torch.tensor(CLIP_STD, device=images.device) * 255.0)
        images = (images.float() - mean) * scale
    x = images.to(dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    if m.cfg.is_vit:
        return m.visual(x, attn_fn, remat)
    return m.visual(x)


def encode_text(
    m: CLIP,
    tokens: torch.Tensor,  # [B, T] integer ids
    dtype: torch.dtype = torch.bfloat16,
    attn_fn=attention,
    remat: bool = False,
) -> torch.Tensor:
    return text_encoder_apply(m, tokens, dtype=dtype, attn_fn=attn_fn, remat=remat)


def cosine_logits(
    img_feats: torch.Tensor,
    txt_feats: torch.Tensor,
    logit_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Normalised cosine logits [B, N] in fp32; optionally scaled by
    ``exp(logit_scale)``."""
    a = l2_normalize(img_feats).float()
    b = l2_normalize(txt_feats).float()
    logits = a @ b.T
    if logit_scale is not None:
        logits = logits * torch.exp(logit_scale)
    return logits
