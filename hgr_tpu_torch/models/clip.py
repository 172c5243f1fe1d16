"""CLIP container: both towers and the logit scale (port of
``hgr_tpu/models/clip.py``).

``CLIP`` carries OpenAI's ``state_dict`` names, so a checkpoint's keys map
one to one. ``clip_init`` draws every parameter from an explicit
``torch.Generator`` with the distributions of the JAX ``*_init`` functions
(not their bits). ``encode_image`` takes NHWC images, raw uint8 or float,
as the JAX function does, normalised with the configuration's
``image_mean`` and ``image_std``. The image tower is the modified ResNet
or, when ``vision_patch_size > 0``, the ViT: OpenAI's block, EVA-02's where
``vision_block`` is ``"eva02"`` (``models/eva_vit.py``, EVA02-CLIP), or
SigLIP's where it is ``"siglip"`` (``models/siglip.py``: no class token,
the MAP head; its text tower bidirectional, pooled at its last position
through a ``head`` with a bias, and a ``logit_bias`` beside
``logit_scale``); only a ViT takes ``remat``, as in JAX. Neither encode
takes an attention: each tower picks the hand kernels or their plain twins
itself, from whether autograd would record (``ops.ln_act.autograd_records``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import annotate
from .eva_vit import EVAVisionTransformer
from .layers import Embedding, LayerNorm, _param, l2_normalize, normal_
from .resnet import ModifiedResNet
from .siglip import SigLIPVisionTransformer
from .text_encoder import text_encoder_apply
from .transformer import Transformer
from .vit import VisionTransformer


# CLIP preprocessing constants (reference clip/clip.py:76-77); the default of
# the on-device normalisation of raw-uint8 batches
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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
    # beyond OpenAI's CLIP (EVA02-CLIP, SigLIP); the defaults are OpenAI's
    vision_block: str = "openai"     # the ViT's block: "openai", "eva02" or "siglip"
    vision_mlp_width: int = 0        # eva02: the SwiGLU's width; siglip: the MLP's
    vision_head_width: int = 64      # a ViT's head width (both towers' in siglip)
    text_activation: str = "quick_gelu"  # the text MLP's: "quick_gelu", "gelu", "gelu_tanh"
    text_mlp_width: int = 0          # 0: 4 x transformer_width
    text_ln_eps: float = 1e-5        # the text tower's LayerNorms'
    text_causal: bool = True         # False: every position attends to every other
    text_pool: str = "eot"           # the text feature's row: "eot" (argmax id) or "last"
    text_head_bias: bool = False     # a bias after text_projection
    text_tokenizer: str = "bpe"      # the ids' tokenizer: "bpe" (OpenAI's, text/) or
                                     # "sentencepiece" (SigLIP's spiece.model, not in the port)
    logit_bias: bool = False         # a logit_bias beside logit_scale (SigLIP's sigmoid loss)
    image_mean: Tuple[float, float, float] = CLIP_MEAN
    image_std: Tuple[float, float, float] = CLIP_STD

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size > 0

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // self.vision_head_width
        return self.vision_width * 32 // 64


# SigLIP So400m/14 at 384 px (Zhai et al. 2023, arXiv:2303.15343; the
# SoViT-400m shape of Alabdulmohsin et al. 2023, arXiv:2305.13035;
# huggingface.co/google/siglip-so400m-patch14-384, config.json, built by
# transformers' models/siglip/modeling_siglip.py): both towers 1,152 wide,
# 27 layers of 16 heads of 72, MLP 4,304 with gelu_pytorch_tanh,
# LayerNorm eps 1e-6; a 27 x 27 grid (T = 729, no class token), the MAP
# head; text 64 positions over 32,000 SentencePiece ids, no mask, pooled
# at the last position through a 1,152 x 1,152 head with a bias; image
# mean and std 0.5
SIGLIP_SO400M = CLIPConfig(
    embed_dim=1152,
    image_resolution=384,
    vision_layers=(27,),
    vision_width=1152,
    vision_patch_size=14,
    context_length=64,
    vocab_size=32000,
    transformer_width=1152,
    transformer_heads=16,
    transformer_layers=27,
    vision_block="siglip",
    vision_mlp_width=4304,
    vision_head_width=72,
    text_activation="gelu_tanh",
    text_mlp_width=4304,
    text_ln_eps=1e-6,
    text_causal=False,
    text_pool="last",
    text_head_bias=True,
    text_tokenizer="sentencepiece",
    logit_bias=True,
    image_mean=(0.5, 0.5, 0.5),
    image_std=(0.5, 0.5, 0.5),
)

# The zoo (hyperparameters of the public OpenAI checkpoints: the JAX
# package's, hgr_tpu/models/clip.py:55-115, and ViT-L/14) and the tiny
# configurations the tests use.
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
    # the port's one name beyond the JAX zoo: OpenAI's "ViT-L/14" (clip/clip.py
    # _MODELS; build_model reads these widths from the checkpoint), T = 257
    "ViT-L/14": CLIPConfig(
        embed_dim=768,
        vision_layers=(24,),
        vision_width=1024,
        vision_patch_size=14,
        transformer_width=768,
        transformer_heads=12,
    ),
    # EVA02-CLIP-L/14 (Sun et al. 2023, arXiv:2303.15389; github.com/baaivision/EVA,
    # EVA-CLIP/rei/eva_clip/model_configs/EVA02-CLIP-L-14.json): EVA-02's block
    # (head_width 64, mlp_ratio 2.6667 -> 2,730, rope with pt_hw_seq_len 16 and
    # intp_freq, naiveswiglu, subln, LayerNorm eps 1e-6: the constants of
    # models/eva_vit.py), T = 257; OpenAI's text
    # block with nn.GELU (the json has no quick_gelu key)
    "EVA02-CLIP-L/14": CLIPConfig(
        embed_dim=768,
        vision_layers=(24,),
        vision_width=1024,
        vision_patch_size=14,
        transformer_width=768,
        transformer_heads=12,
        vision_block="eva02",
        vision_mlp_width=2730,
        text_activation="gelu",
    ),
    "SigLIP-SO400M/14@384": SIGLIP_SO400M,
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
    "TEST-EVA": CLIPConfig(
        embed_dim=64,
        image_resolution=32,
        vision_layers=(2,),
        vision_width=128,
        vision_patch_size=8,
        context_length=77,
        vocab_size=512,
        transformer_width=32,
        transformer_heads=2,
        transformer_layers=2,
        vision_block="eva02",
        vision_mlp_width=341,  # int(128 * 2.6667), EVA's rounding; grid 4, so
                               # the rotary's positions are scaled by 16 / 4
        text_activation="gelu",
    ),
    # SigLIP's block at head width 72, 2 layers, no class token (T = 16)
    "TEST-SIGLIP": replace(
        SIGLIP_SO400M,
        embed_dim=144,
        image_resolution=32,
        vision_layers=(2,),
        vision_width=144,
        vision_patch_size=8,
        context_length=16,
        vocab_size=512,
        transformer_width=144,
        transformer_heads=2,
        transformer_layers=2,
        vision_mlp_width=538,
        text_mlp_width=538,
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
        if (cfg.vision_block not in ("openai", "eva02", "siglip")
                or cfg.text_activation not in ("quick_gelu", "gelu", "gelu_tanh")
                or cfg.text_pool not in ("eot", "last")
                or cfg.text_tokenizer not in ("bpe", "sentencepiece")):
            raise ValueError(f"unknown vision_block {cfg.vision_block!r}, text_activation "
                             f"{cfg.text_activation!r}, text_pool {cfg.text_pool!r} or "
                             f"text_tokenizer {cfg.text_tokenizer!r}")
        if cfg.vision_block == "siglip":
            self.visual = SigLIPVisionTransformer(
                cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
                cfg.vision_layers[0], cfg.vision_heads, cfg.vision_mlp_width,
            )
        elif cfg.vision_block == "eva02":
            self.visual = EVAVisionTransformer(
                cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
                cfg.vision_layers[0], cfg.vision_heads, cfg.vision_mlp_width, cfg.embed_dim,
            )
        elif cfg.is_vit:
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
        self.transformer = Transformer(w, cfg.transformer_layers, cfg.transformer_heads,
                                       activation=cfg.text_activation,
                                       mlp_width=cfg.text_mlp_width or 4 * w,
                                       eps=cfg.text_ln_eps)
        self.token_embedding = Embedding(cfg.vocab_size, w)
        self.positional_embedding = _param(cfg.context_length, w)
        self.ln_final = LayerNorm(w, cfg.text_ln_eps)
        self.text_projection = _param(w, cfg.embed_dim)
        # SigLIP's text head is a Linear with a bias: OpenAI's projection
        # ([in, out]) and this bias; and its sigmoid loss's logit bias
        self.text_projection_bias = _param(cfg.embed_dim) if cfg.text_head_bias else None
        self.logit_scale = _param(())
        self.logit_bias = _param(()) if cfg.logit_bias else None


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
        if m.text_projection_bias is not None:
            m.text_projection_bias.zero_()
        if m.logit_bias is not None:
            # SigLIP's initialisation: t' = log 10, b = -10 (arXiv:2303.15343 sec. 3.2)
            m.logit_scale.fill_(math.log(10.0))
            m.logit_bias.fill_(-10.0)
    return m.to(device) if device is not None else m


def encode_image(
    m: CLIP,
    images: torch.Tensor,  # [B, H, W, 3] pre-normalised float, or raw uint8
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    with annotate("clip.encode_image"):
        if images.dtype == torch.uint8:
            # raw uint8 edge: normalise on the device in fp32, then cast
            with annotate("clip.normalize"):
                mean = torch.tensor(m.cfg.image_mean, device=images.device) * 255.0
                scale = 1.0 / (torch.tensor(m.cfg.image_std, device=images.device) * 255.0)
                images = (images.float() - mean) * scale
        x = images.to(dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        if m.cfg.is_vit:
            return m.visual(x, remat)
        return m.visual(x)


def encode_text(
    m: CLIP,
    tokens: torch.Tensor,  # [B, T] integer ids
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    with annotate("clip.encode_text"):
        return text_encoder_apply(m, tokens, dtype=dtype, remat=remat)


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
