"""CLIP text encoder: token embedding -> causal transformer -> EOT pooling
(port of ``hgr_tpu/models/text_encoder.py:36-55``).

Behaviour of the reference ``CLIP.encode_text`` (``clip/model.py:339-352``):
learned positional embeddings, causal mask, final LayerNorm, pooling at the
EOT token (the argmax of the token ids, since EOT has the highest id), and
the matmul with ``text_projection``. The parameters are the top-level
OpenAI names of the CLIP module (``token_embedding``,
``positional_embedding``, ``transformer``, ``ln_final``,
``text_projection``). SigLIP's text tower (``SiglipTextTransformer`` of
``transformers``' ``modeling_siglip.py``) runs the same stack with no mask
(``text_causal`` False) and pools its last position (``text_pool``
``"last"``) through a head with a bias (``text_projection_bias``): every
position, pad ids included, reaches its feature.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import ln_act
from .layers import causal_mask


def text_mask(cfg, T: int, device) -> Optional[torch.Tensor]:
    """The text tower's additive mask at ``T`` positions: causal, or none."""
    return causal_mask(T, device=device) if cfg.text_causal else None


def pool_text(m, x: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The feature of each prompt from the last LayerNorm's rows ``x``:
    its EOT row (the first maximal id, as jnp.argmax) or its last row,
    through ``text_projection`` and the head's bias where there is one."""
    if m.cfg.text_pool == "last":
        pooled = x[:, -1]
    else:
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    out = pooled @ m.text_projection.to(dtype)
    return out if m.text_projection_bias is None else out + m.text_projection_bias.to(dtype)


def text_encoder_apply(
    m,                      # models.clip.CLIP
    tokens: torch.Tensor,   # [B, T] integer ids
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    T = tokens.shape[1]
    x = m.token_embedding(tokens).to(dtype)
    x = x + m.positional_embedding[:T].to(dtype)
    records = ln_act.autograd_records(x, m.transformer, m.ln_final)
    x = m.transformer(x, text_mask(m.cfg, T, x.device), records, remat, ln_final=m.ln_final)
    return pool_text(m, x, tokens, dtype)
