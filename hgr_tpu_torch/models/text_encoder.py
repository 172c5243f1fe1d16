"""CLIP text encoder: token embedding -> causal transformer -> EOT pooling
(port of ``hgr_tpu/models/text_encoder.py:36-55``).

Behaviour of the reference ``CLIP.encode_text`` (``clip/model.py:339-352``):
learned positional embeddings, causal mask, final LayerNorm, pooling at the
EOT token (the argmax of the token ids, since EOT has the highest id), and
the matmul with ``text_projection``. The parameters are the top-level
OpenAI names of the CLIP module (``token_embedding``,
``positional_embedding``, ``transformer``, ``ln_final``,
``text_projection``).
"""

from __future__ import annotations

import torch

from ..ops import ln_act
from .layers import causal_mask


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
    x = m.transformer(x, causal_mask(T, device=x.device), records, remat,
                      ln_final=m.ln_final)
    eot = tokens.argmax(dim=-1)  # first maximal index, as jnp.argmax
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return pooled @ m.text_projection.to(dtype)
