"""A configuration's reference family, and the helpers built on its encoders.

A family is one file, ``benchmark/families/<family>.py``; a configuration
names it by its ``"family"`` key, and one without the key is ``clip``.
Everything the harness computes from a model's architecture comes from the
family: the weights it draws, the reference's encoders, the work counts
and the cut to the program's TEST sizes. A family defines every name of
:data:`INTERFACE`:

- ``draw_weights(cfg, seed, device)``: the state dict both sides load;
- ``encode_image(sd, cfg, images, quant=None)``: [B, H, W, 3] uint8 ->
  [B, embed] unnormalised features; ``encode_text(sd, cfg, tokens,
  quant=None)``: [N, T] ids -> [N, embed];
- ``image_flops(cfg)``, ``text_flops(cfg, lengths)``: the operations the
  inputs need (``hbench/work.py`` says how they are counted);
- ``image_attention_work(cfg, images)``: K1's operations and bytes in the
  image tower over ``images`` images, or None where K1 does not run there;
  ``text_attention_work(cfg, lengths)``: K1's in one bank build;
- ``tiny(cfg)``: the configuration cut to the program's TEST sizes, for
  the CPU tests.

It imports nothing of the program, and of ``hbench`` only the
reference's side (``reference``, ``work``, ``inputs`` and the other
modules ``tests/test_bench_imports.py`` lists).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import torch

from .reference import Quant, normalize

DEFAULT = "clip"
INTERFACE = ("draw_weights", "encode_image", "encode_text", "image_flops", "text_flops",
             "image_attention_work", "text_attention_work", "tiny")


def load(cfg: Dict, bench_dir: Path) -> ModuleType:
    """The family ``cfg`` names, from ``bench_dir/families/``."""
    name = cfg.get("family", DEFAULT)
    path = bench_dir / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "hbench_family_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"family {name!r} ({path}) lacks {missing}")
    return mod


@torch.no_grad()
def bank_rows(fam: ModuleType, sd, cfg: Dict, tokens: torch.Tensor, quant: Quant = None,
              chunk: int = 1024) -> torch.Tensor:
    """Normalised text features of ``tokens`` [N, T] by the family's
    ``encode_text``, in chunks, at the length of the longest prompt
    (positions past a prompt's EOT reach no feature under the causal mask)."""
    t_need = int(tokens.argmax(dim=1).max()) + 1
    parts: List[torch.Tensor] = []
    for i in range(0, tokens.shape[0], chunk):
        parts.append(normalize(fam.encode_text(sd, cfg, tokens[i: i + chunk, :t_need], quant)))
    return torch.cat(parts)


@torch.no_grad()
def image_features(fam: ModuleType, sd, cfg: Dict, images: torch.Tensor, quant: Quant = None,
                   chunk: int = 128) -> torch.Tensor:
    """The family's ``encode_image`` over ``images``, in chunks."""
    return torch.cat([fam.encode_image(sd, cfg, images[i: i + chunk], quant)
                      for i in range(0, images.shape[0], chunk)])
