"""Per-depth loss weighting over a whole pair schedule (port of
``hgr_tpu/train/weights.py``).

The reference's ``get_weights`` (``model/clip_tree.py:198-219``) builds a
length-L weight vector per loop level; here, given per-pair ``(pos,
length)`` tensors, ``pair_weights`` returns ``w[pos]`` of the length-``length``
vector for each pair. The six modes:

- ``equal``          1/L
- ``increasing``     (pos+1) / sum(1..L)
- ``decreasing``     (L-pos) / sum(1..L)
- ``nl_increasing``  (pos+1)^3 / sum(i^3)
- ``nl_decreasing``  (L-pos)^3 / sum(i^3)
- ``adaptive``       softmax(100**layer_weight[:L])[pos], where
                     ``layer_weight`` is trainable (it receives its only
                     gradient here)
"""

from __future__ import annotations

import torch

MODES = (
    "equal",
    "increasing",
    "decreasing",
    "adaptive",
    "nl_increasing",
    "nl_decreasing",
)


def pair_weights(
    method: str,
    pos: torch.Tensor,           # [P] integer, position within the loop (0-based)
    length: torch.Tensor,        # [P] integer, loop length (>= 1)
    layer_weight: torch.Tensor,  # [n_levels] fp32 (adaptive mode only)
) -> torch.Tensor:
    """Weight of each (pos, length) pair under ``method`` -> [P] fp32."""
    posf = pos.float()
    Lf = length.float()
    if method == "equal":
        return 1.0 / Lf
    if method == "increasing":
        return (posf + 1.0) / (Lf * (Lf + 1.0) / 2.0)
    if method == "decreasing":
        return (Lf - posf) / (Lf * (Lf + 1.0) / 2.0)
    if method == "nl_increasing":
        num = (posf + 1.0) ** 3
    elif method == "nl_decreasing":
        num = (Lf - posf) ** 3
    elif method == "adaptive":
        n_levels = layer_weight.shape[0]
        base = torch.pow(100.0, layer_weight)                            # [n_levels]
        idx = torch.arange(n_levels, device=layer_weight.device)[None, :]
        logits = torch.where(idx < length[:, None], base[None, :], float("-inf"))
        sm = torch.softmax(logits, dim=-1)                               # [P, n_levels]
        return sm.gather(1, pos[:, None].long())[:, 0]
    else:
        raise ValueError(f"unknown weighting method {method!r}; options {MODES}")
    # cubic modes share the denominator sum_{i=1..L} i^3 = (L(L+1)/2)^2
    return num / torch.square(Lf * (Lf + 1.0) / 2.0)
