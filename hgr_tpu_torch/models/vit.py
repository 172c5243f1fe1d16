"""Vision Transformer image encoder, CLIP's ViT-B and ViT-L (port of
``hgr_tpu/models/vit.py:17-58``).

Behaviour of the reference ``VisionTransformer`` (``clip/model.py:202-236``):
conv patchify, class token, learned positional embeddings, pre and post
LayerNorm, projection to the shared embedding dim. The self-attention has no
mask, so on the card the fused kernel runs at T = grid² + 1 (50 for
ViT-B/32, 197 for ViT-B/16, 257 for ViT-L/14). Each block records the spans
``vit.attn`` and ``vit.mlp``. Names are OpenAI's (``conv1.weight``,
``class_embedding``, ``transformer.resblocks.{i}.*``, ``ln_post``,
``proj``). Whether autograd would record is asked once an encode
(``ops.ln_act.autograd_records``) and handed to the ``Transformer``; where
it would record nothing, ``ln_pre`` and ``ln_post`` run through
``ops.ln_act.add_layer_norm`` (K3 on CUDA) and the blocks run fused, with
K1's attention (``models/transformer.py``); the last block's MLP add stays
a plain add, since ``ln_post`` reads only the class token's row.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import ln_act
from .layers import Conv2d, LayerNorm, _param, normal_
from .transformer import Transformer


class VisionTransformer(nn.Module):
    def __init__(
        self,
        input_resolution: int,
        patch_size: int,
        width: int,
        layers: int,
        heads: int,
        output_dim: int,
    ):
        super().__init__()
        n_patches = (input_resolution // patch_size) ** 2
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size)
        self.class_embedding = _param(width)
        self.positional_embedding = _param(n_patches + 1, width)
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, span="vit")
        self.ln_post = LayerNorm(width)
        self.proj = _param(width, output_dim)

    def init(self, g: torch.Generator) -> None:
        """``vit_init``: normal ``width^-0.5`` for the patch conv, class
        token, positions and projection; the reference block init."""
        scale = self.class_embedding.shape[0] ** -0.5
        for t in (self.conv1.weight, self.class_embedding, self.positional_embedding):
            normal_(t, scale, g)
        self.ln_pre.init()
        self.transformer.init(g)
        self.ln_post.init()
        normal_(self.proj, scale, g)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: [B, 3, H, W] in the compute dtype -> [B, output_dim]."""
        x = self.conv1(x)                                  # [B, width, g, g]
        B, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)                   # [B, g*g, width]
        cls = self.class_embedding.to(x.dtype).expand(B, 1, width)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        records = ln_act.autograd_records(x, self)

        def norm(t, ln):
            return ln(t) if records else ln_act.add_layer_norm(t, None, ln)[1]

        x = norm(x, self.ln_pre)
        x = self.transformer(x, None, records, remat)
        x = norm(x[:, :1], self.ln_post)[:, 0]
        return x @ self.proj.to(x.dtype)
