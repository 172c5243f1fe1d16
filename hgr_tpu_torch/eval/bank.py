"""Class-embedding bank: all node prompts -> one ``[N_pad, D]`` tensor
(port of ``hgr_tpu/eval/bank.py``).

Equivalent of the reference's ``update_classifier``
(``model/clip_tree.py:318-325``): the prompts are encoded in fixed-size
chunks, L2-normalised and cast to the output dtype. The pad rows (all-zero
token rows added by ``pad_tokens``) are encoded like any other row, as the
JAX package does; every consumer masks them out through the train/test
masks.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.layers import l2_normalize
from ..utils.profiling import annotate


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_tokens(tokens: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad the [N, T] token matrix with all-zero rows to n_pad."""
    n, t = tokens.shape
    out = np.zeros((n_pad, t), dtype=tokens.dtype)
    out[:n] = tokens
    return out


@torch.inference_mode()
def build_bank(
    tokens: torch.Tensor,          # [N_pad, T] integer ids, N_pad % chunk == 0
    encode_text_fn: Callable,      # [C, T] -> [C, D]
    chunk: int = 512,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Encode all node prompts into a normalised [N_pad, D] bank."""
    n_pad = tokens.shape[0]
    if n_pad % chunk:
        raise ValueError(f"N_pad {n_pad} not divisible by chunk {chunk}")
    with annotate("bank.build"):
        parts = [
            l2_normalize(encode_text_fn(tokens[i: i + chunk])).to(out_dtype)
            for i in range(0, n_pad, chunk)
        ]
        return torch.cat(parts)


@torch.inference_mode()
def build_bank_ids(
    params,
    n_pad: int,
    text_fn: Callable,             # (params, ids [C]) -> normalised [C, D]
    chunk: int = 512,
    out_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """Bank of a variant text path (the CoOp prompt learner): class-id
    chunks through ``text_fn`` (``hgr_tpu/eval/bank.py:57-73``)."""
    if n_pad % chunk:
        raise ValueError(f"N_pad {n_pad} not divisible by chunk {chunk}")
    with annotate("bank.build"):
        ids = torch.arange(n_pad, device=device)
        return torch.cat([text_fn(params, ids[i: i + chunk]).to(out_dtype)
                          for i in range(0, n_pad, chunk)])


def bank_logits(img_feats: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """[B, D] image features (unnormalised) x [N_pad, D] bank -> [B, N_pad]
    raw cosine logits in fp32, no logit scale (``model/clip_tree.py:
    328-332``). Both operands are upcast before the product: a bf16 x bf16
    product is exact in fp32, so this is the fp32-accumulated product the
    JAX package asks for (with TF32 off, see ``device.py``)."""
    feats = l2_normalize(img_feats)
    return feats.float() @ bank.float().T
