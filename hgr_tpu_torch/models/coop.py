"""CoOp learned-prompt variant (port of ``hgr_tpu/models/coop.py:57-171``).

The reference's ``PromptLearner`` (``model/CoOp.py:31-162``) keeps 16
learned context vectors and places the class name after, around or before
them. As in the JAX package, only two integer tables are stored:

- ``tokenized [N, T]``: the "X X .. X <name>." prompt tokens;
- ``ctx_map   [N, T]``: which context vector fills each slot (-1 keeps the
  token's own embedding);

and the prompt embeddings are made for the requested classes alone: gather
the token embeddings, put the trainable ``ctx`` rows into their slots, run
the causal transformer, pool at argmax(tokens) (EOT has the highest id).
The gradient reaches ``ctx`` only through its slots.

The text tower picks its attention itself (``models/transformer.py``):
K1 where autograd records nothing (the class bank), the plain
``attention_scores`` where it records (the train step, through ``ctx`` even
when CLIP is frozen). Callers pass no attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import ln_act
from .layers import causal_mask, l2_normalize
from .text_encoder import pool_text

N_CTX_DEFAULT = 16
POSITIONS = ("end", "middle", "front")


@dataclass
class CoopStatic:
    """Host-built static prompt layout (not trainable)."""

    tokenized: np.ndarray  # [N, T] int32
    ctx_map: np.ndarray    # [N, T] int32, ctx row index or -1
    n_ctx: int
    position: str


def build_coop_static(
    name_token_ids: Sequence[Sequence[int]],
    context_length: int,
    sot_id: int,
    eot_id: int,
    n_ctx: int = N_CTX_DEFAULT,
    position: str = "end",
    placeholder_id: int = 0,
) -> CoopStatic:
    """Per-class prompt tokens and ctx slot maps, "sot X X .. X <name> eot"
    with the name cut to the room left (``hgr_tpu/models/coop.py:57-111``)."""
    if position not in POSITIONS:
        raise ValueError(f"position {position!r} not in {POSITIONS}")
    n = len(name_token_ids)
    toks = np.zeros((n, context_length), np.int32)
    cmap = np.full((n, context_length), -1, np.int32)
    room = context_length - 2 - n_ctx
    for i, name_ids in enumerate(name_token_ids):
        name_ids = list(name_ids)[:room]
        L = len(name_ids)
        if position == "end":
            body_tokens = [placeholder_id] * n_ctx + name_ids
            body_ctx = list(range(n_ctx)) + [-1] * L
        elif position == "front":
            body_tokens = name_ids + [placeholder_id] * n_ctx
            body_ctx = [-1] * L + list(range(n_ctx))
        else:  # middle
            half = n_ctx // 2
            body_tokens = [placeholder_id] * half + name_ids + [placeholder_id] * (n_ctx - half)
            body_ctx = list(range(half)) + [-1] * L + list(range(half, n_ctx))
        row = [sot_id] + body_tokens + [eot_id]
        toks[i, : len(row)] = row
        cmap[i, 1: 1 + len(body_ctx)] = body_ctx
    # exact truncation, as for the node-token bank: with a causal mask and
    # EOT pooling, positions past a prompt's EOT never reach its feature;
    # the tail is cut to a multiple of 16, at least 16 (coop.py:100-110)
    t_need = int(toks.argmax(axis=1).max()) + 1  # eot_id is the largest id
    t_trunc = min(context_length, max(16, ((t_need + 15) // 16) * 16))
    return CoopStatic(tokenized=np.ascontiguousarray(toks[:, :t_trunc]),
                      ctx_map=np.ascontiguousarray(cmap[:, :t_trunc]),
                      n_ctx=n_ctx, position=position)


def coop_ctx_init(generator: torch.Generator, n_ctx: int, width: int, device=None) -> torch.Tensor:
    """Learned context vectors, N(0, 0.02) like the reference
    (``model/CoOp.py:97``), drawn on the CPU from ``generator``."""
    ctx = 0.02 * torch.randn((n_ctx, width), generator=generator)
    return ctx.to(device) if device is not None else ctx


def coop_encode_text(
    m,                          # models.clip.CLIP
    ctx: torch.Tensor,          # [n_ctx, W] trainable context
    tokenized: torch.Tensor,    # [U, T] integer ids (gathered for current ids)
    ctx_map: torch.Tensor,      # [U, T] integer ctx rows, -1 = the token's own
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    """Prompt-conditioned text features [U, D] (reference ``TextEncoder`` and
    ``PromptLearner.forward``, ``model/CoOp.py:40-52,106-160``)."""
    T = tokenized.shape[1]
    emb = m.token_embedding(tokenized).to(dtype)                    # [U, T, W]
    ctx_rows = ctx.to(dtype)[ctx_map.clamp_min(0)]                  # [U, T, W]
    emb = torch.where((ctx_map >= 0)[..., None], ctx_rows, emb)
    x = emb + m.positional_embedding[:T].to(dtype)
    records = ln_act.autograd_records(x, m.transformer, m.ln_final)
    if not m.cfg.text_causal:
        raise ValueError("CoOp's prompts are cut after their EOT, which only a causal text "
                         "tower allows")
    x = m.transformer(x, causal_mask(T, device=x.device), records, remat,
                      ln_final=m.ln_final)
    return pool_text(m, x, tokenized, dtype)


def make_coop_text_fn(
    static: CoopStatic,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
    device=None,
) -> Callable:
    """``text_fn(params, ids) -> normalised [len(ids), D]`` through the prompt
    learner, reading ``params["clip"]`` and ``params["coop_ctx"]``: the text
    path of the OM loss and of the class bank (``coop.py:147-171``). The
    tables go to ``device`` once."""
    tokenized = torch.as_tensor(static.tokenized, device=device).long()
    ctx_map = torch.as_tensor(static.ctx_map, device=device).long()

    def text_fn(params, ids):
        feats = coop_encode_text(params["clip"], params["coop_ctx"], tokenized[ids],
                                 ctx_map[ids], dtype=dtype, remat=remat)
        return l2_normalize(feats)

    return text_fn
