"""SigLIP's vision transformer, the image tower of SigLIP So400m/14 (Zhai et
al. 2023, "Sigmoid Loss for Language Image Pre-Training", arXiv:2303.15343;
the SoViT-400m shape of Alabdulmohsin et al. 2023, arXiv:2305.13035), as
``transformers``' ``models/siglip/modeling_siglip.py`` builds it
(``SiglipVisionTransformer`` with ``SiglipMultiheadAttentionPoolingHead``).

The tower, for T = grid² tokens (no class token), every LayerNorm with eps
``LN_EPS`` (1e-6):

- ``x = conv(img) + b + pos``: the patch conv with a bias over the grid
  (the pixels a stride leaves past the last patch unread, as PyTorch's conv
  leaves them: 6 of 384 at patch 14), positions ``positional_embedding``;
  no ``ln_pre``;
- the pre-LN blocks of ``models/transformer.py`` (OpenAI's names, the fused
  ``in_proj``), heads of ``vision_head_width`` (72), MLP ``mlp_width``
  (4,304) wide with GELU's tanh form;
- ``y = post_layernorm(x)`` over all T rows;
- the MAP head: ``a = MHA(probe, y, y)`` (one learned query, the packed
  ``in_proj`` and ``out_proj`` of ``nn.MultiheadAttention``),
  ``h = a + mlp(layernorm(a))``, the feature ``h[0]``; no projection, so
  the embedding is the tower's width.

Where autograd would record nothing (``ops.ln_act.autograd_records``, asked
once an encode and handed to the ``Transformer``), the blocks run fused
with K1's attention and K3's add + LayerNorm at the tower's width, the
last block's add inside ``post_layernorm`` over all rows; otherwise the
plain blocks and ``post_layernorm``. The MAP head, one query against T
keys, runs as plain PyTorch ops on both paths and records the span
``siglip.map_head``; the blocks record ``vit.attn`` and ``vit.mlp``. The
weights are cast to the activation dtype at use, as every tower's are:
the packed ``in_proj`` needs no building.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ln_act
from ..utils.profiling import annotate
from .layers import Conv2d, LayerNorm, _param, attention_scores, linear, normal_
from .transformer import MLP, MultiheadAttention, Transformer

LN_EPS = 1e-6  # SiglipVisionConfig's (and SiglipTextConfig's) layer_norm_eps


class MAPHead(nn.Module):
    """Multihead attention pooling: a learned ``probe`` queries the tower's
    rows, then a pre-LN MLP with its residual add."""

    def __init__(self, width: int, heads: int, mlp_width: int):
        super().__init__()
        self.heads = heads
        self.probe = _param(1, 1, width)
        self.attn = MultiheadAttention(width)
        self.layernorm = LayerNorm(width, LN_EPS)
        self.mlp = MLP(width, mlp_width)

    def init(self, g: torch.Generator) -> None:
        width = self.probe.shape[-1]
        normal_(self.probe, width ** -0.5, g)
        normal_(self.attn.in_proj_weight, width ** -0.5, g)
        nn.init.zeros_(self.attn.in_proj_bias)
        self.attn.out_proj.init(g)
        self.layernorm.init()
        self.mlp.c_fc.init(g)
        self.mlp.c_proj.init(g)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """y: [B, T, W] -> [B, W]."""
        B, T, W = y.shape
        a = self.attn
        w, b = a.in_proj_weight, a.in_proj_bias
        q = linear(self.probe.to(y.dtype).expand(B, 1, W), w[:W], b[:W])
        kv = linear(y, w[W:], b[W:])
        k, v = kv.split(W, dim=-1)

        def heads(t):
            return t.view(B, t.shape[1], self.heads, W // self.heads).transpose(1, 2)

        o = attention_scores(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(B, 1, W)
        o = linear(o, a.out_proj.weight, a.out_proj.bias)
        h = self.mlp.c_fc(self.layernorm(o))
        o = o + self.mlp.c_proj(F.gelu(h, approximate="tanh"))
        return o[:, 0]


class SigLIPVisionTransformer(nn.Module):
    def __init__(
        self,
        input_resolution: int,
        patch_size: int,
        width: int,
        layers: int,
        heads: int,
        mlp_width: int,
    ):
        super().__init__()
        n_patches = (input_resolution // patch_size) ** 2
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=True)
        self.positional_embedding = _param(n_patches, width)
        self.transformer = Transformer(width, layers, heads, span="vit",
                                       activation="gelu_tanh", mlp_width=mlp_width, eps=LN_EPS)
        self.post_layernorm = LayerNorm(width, LN_EPS)
        self.attn_pool = MAPHead(width, heads, mlp_width)

    def init(self, g: torch.Generator) -> None:
        """The ViT's draws (``vit_init``): normal ``width^-0.5`` for the patch
        conv and the positions, the reference block init; zero biases."""
        scale = self.positional_embedding.shape[1] ** -0.5
        normal_(self.conv1.weight, scale, g)
        nn.init.zeros_(self.conv1.bias)
        normal_(self.positional_embedding, scale, g)
        self.transformer.init(g)
        self.post_layernorm.init()
        self.attn_pool.init(g)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: [B, 3, H, W] in the compute dtype -> [B, width]."""
        x = self.conv1(x)                                   # [B, width, g, g]
        x = x.flatten(2).transpose(1, 2)                    # [B, g*g, width]
        x = x + self.positional_embedding.to(x.dtype)
        records = ln_act.autograd_records(x, self)
        y = self.transformer(x, None, records, remat, ln_final=self.post_layernorm)
        with annotate("siglip.map_head"):
            return self.attn_pool(y)
