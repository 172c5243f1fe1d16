"""The OM hierarchy-aware contrastive loss as one batched step (port of
``hgr_tpu/train/om.py:38-135``).

The reference computes the loss with a Python double loop over the ancestor
chain, one text-encoder forward and backward per (outer, inner) pair
(``model/clip_tree.py:222-281``). Here, as in the JAX package, the host
builds a padded pair schedule (``sampling.py``); the step encodes the image
batch once and the de-duplicated union of all compare sets once, computes
every pair's logits, applies the masked cross-entropy with per-pair
hierarchy weights, and takes one backward through the sum:

    loss = sum_p valid_p * w_in[p] * w_out[p] * CE_p

where CE_p is the cross-entropy of pair p's compare set averaged over all B
rows of the batch, zero-padded rows included (``hgr_tpu/train/om.py:75``
takes no ``valid``).

The step passes the towers no attention: each tower sees that autograd
records (``ops.ln_act.autograd_records``). The ResNet image tower then runs
K2, its BatchNorm epilogue kernel, as an autograd Function with a
hand-written backward (``ops.bn_act.bn_act_autograd``); the transformer
towers run the plain ``attention_scores`` and twins, the counterpart of the
JAX step, which calls the encoders with no attention argument and so runs
XLA's attention (``om.py:98,103``). That is not a fallback from K1 and K3,
which have no backward and are never called under autograd. A frozen tower
that records nothing (the image tower of a CoOp ``ctx`` step) runs its
kernels' no-gradient path.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.clip import encode_image, encode_text
from ..models.layers import l2_normalize
from .weights import pair_weights


def resolve_weight_modes(training_method: str, weights: str, weighting: str) -> Tuple[str, str]:
    """(in_mode, out_mode) per the reference's weighting switch
    (``model/clip_tree.py:264-272``); the hierarchical method always uses
    ``weights`` on its single loop (``:308``)."""
    if training_method == "hierarchical":
        return weights, "equal"
    if weighting == "out":
        return "equal", weights
    if weighting == "in":
        return weights, "equal"
    return weights, weights  # "both"


def pair_ce_loss(
    img: torch.Tensor,             # [B, D] normalised image features
    tfeat: torch.Tensor,           # [U, D] normalised text features
    sched: Dict[str, torch.Tensor],
    layer_weight: torch.Tensor,
    scale: torch.Tensor,           # exp(logit_scale)
    *,
    in_mode: str,
    out_mode: str,
) -> torch.Tensor:
    """Masked weighted pair cross-entropy on encoded features (reference
    ``model/clip_tree.py:261-279``). Each pair's logits are gathered from
    one [B, U] product: the same dot products as the JAX package's
    [P, B, C] einsum, without materialising [P, C, D] features."""
    scores = img.float() @ tfeat.float().T                         # [B, U]
    logits = scores[:, sched["inv"]].permute(1, 0, 2) * scale      # [P, B, C]
    logits = torch.where(sched["compare_valid"][:, None, :], logits, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    P, B, _ = logp.shape
    lab = sched["label"][:, None, None].expand(P, B, 1)
    ce = -logp.gather(2, lab)[..., 0].mean(dim=1)                  # [P]

    w_in = pair_weights(in_mode, sched["in_pos"], sched["in_len"], layer_weight)
    w_out = pair_weights(out_mode, sched["out_pos"], sched["out_len"], layer_weight)
    w = torch.where(sched["pair_valid"], w_in * w_out, 0.0)
    return torch.sum(ce * w)


def om_loss(
    params: Dict[str, Any],        # {"clip": CLIP module, "layer_weight": [L]}
    images: torch.Tensor,          # [B, H, W, 3]
    node_tokens: torch.Tensor,     # [N_pad, T] integer ids (the full prompt bank)
    sched: Dict[str, torch.Tensor],  # sched_to_device(PairSchedule)
    *,
    dtype: torch.dtype,
    in_mode: str,
    out_mode: str,
    remat: bool = False,
    text_fn: Callable = None,
) -> torch.Tensor:
    m = params["clip"]
    img = encode_image(m, images, dtype=dtype, remat=remat)
    img = l2_normalize(img)                                        # [B, D]

    if text_fn is None:
        toks = node_tokens[sched["unique"]]                        # [U, T]
        tfeat = encode_text(m, toks, dtype=dtype, remat=remat)
        tfeat = l2_normalize(tfeat)                                # [U, D]
    else:
        # a variant text path (the CoOp prompt learner): class ids ->
        # normalised features from whatever trainable leaves it needs
        tfeat = text_fn(params, sched["unique"])

    return pair_ce_loss(
        img, tfeat, sched, params["layer_weight"], torch.exp(m.logit_scale),
        in_mode=in_mode, out_mode=out_mode,
    )


def make_om_loss_fn(
    dtype: torch.dtype,
    training_method: str,
    weights: str,
    weighting: str,
    remat: bool = False,
    text_fn: Callable = None,
) -> Callable:
    """``om_loss`` with the run's settings bound. The CLIP module carries its
    own config, so unlike the JAX function this takes none."""
    in_mode, out_mode = resolve_weight_modes(training_method, weights, weighting)
    return functools.partial(
        om_loss, dtype=dtype, in_mode=in_mode, out_mode=out_mode,
        remat=remat, text_fn=text_fn,
    )
