"""CLIP flat fine-tune: plain cross-entropy over seen-class cosine logits
(port of ``hgr_tpu/baselines/clip_flat.py:29-75``).

The reference's ``baseline/CLIP/clip_train.py``: encode the image batch and
the SEEN-class prompt bank, cross-entropy against the batch labels (their
positions in the seen bank), then the shared hierarchical eval. Every step
re-encodes all seen prompts (``clip_train.py:212-214``), under autograd, so
the towers run the plain ``attention_scores`` (they see that autograd
records), without remat, as the JAX step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from ..models.clip import encode_image, encode_text
from ..models.layers import l2_normalize


def step_lr(base_lr: float, gamma: float = 0.1, step_size: int = 25) -> Callable[[int], float]:
    """torch StepLR (``clip_train.py:254``), read per epoch."""
    return lambda epoch: base_lr * gamma ** math.floor(epoch / step_size)


def flat_loss(params: Dict[str, Any], images: torch.Tensor, seen_tokens: torch.Tensor,
              labels: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Mean cross-entropy of ``exp(logit_scale)``-scaled cosines between the
    images and the seen prompts; ``labels`` index ``seen_tokens``' rows."""
    m = params["clip"]
    img = l2_normalize(encode_image(m, images, dtype=dtype))
    txt = l2_normalize(encode_text(m, seen_tokens, dtype=dtype))
    logits = img.float() @ txt.float().T * torch.exp(m.logit_scale)
    return torch.nn.functional.cross_entropy(logits, labels.long())


def make_flat_loss_fn(dtype: torch.dtype = torch.bfloat16) -> Callable:
    return lambda params, images, seen_tokens, labels: flat_loss(
        params, images, seen_tokens, labels, dtype)


def make_flat_train_step(tx, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """-> ``step(params, opt_state, images, seen_tokens, labels) -> (params,
    opt_state, loss)``: the loss's backward, then ``tx.update(params,
    opt_state)``, which updates the tensors in place (``train.Optimizer``
    or ``baselines.optim.Adam``)."""
    from ..train.trainer import freeze_params

    def step(params, opt_state, images, seen_tokens, labels):
        loss = flat_loss(freeze_params(params, ()), images, seen_tokens, labels, dtype)
        loss.backward()
        tx.update(params, opt_state)
        return params, opt_state, loss.detach()

    return step
