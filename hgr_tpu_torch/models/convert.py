"""Weight carry-over from the JAX package's parameter pytree.

``from_jax_params`` is the inverse of ``hgr_tpu/models/convert.py:
convert_state_dict`` (``:160-205``): it takes the JAX pytree with numpy (or
array-like) leaves and returns an OpenAI-named ``state_dict`` of fp32 torch
tensors that ``CLIP.load_state_dict`` accepts. It unstacks the scanned
transformer blocks, transposes conv weights HWIO -> OIHW and linear weights
``[in, out]`` -> ``[out, in]``, and repacks ``qkv`` into ``in_proj_weight``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .clip import CLIPConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))


def _linear(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    sd[f"{name}.bias"] = _t(p["b"])


def _ln(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _ln(sd, name, p)
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])


def _blocks(sd: StateDict, prefix: str, stacked: Mapping[str, Any], n: int) -> None:
    """Unstack ``{"blocks": pytree with a leading layer axis}``."""
    b = stacked["blocks"]
    for i in range(n):
        name = f"{prefix}.resblocks.{i}"
        sd[f"{name}.attn.in_proj_weight"] = _t(np.asarray(b["attn"]["qkv"]["w"][i]).T)
        sd[f"{name}.attn.in_proj_bias"] = _t(b["attn"]["qkv"]["b"][i])
        _linear(sd, f"{name}.attn.out_proj",
                {k: v[i] for k, v in b["attn"]["out"].items()})
        _ln(sd, f"{name}.ln_1", {k: v[i] for k, v in b["ln_1"].items()})
        for fc in ("c_fc", "c_proj"):
            _linear(sd, f"{name}.mlp.{fc}",
                    {k: v[i] for k, v in b["mlp"][fc].items()})
        _ln(sd, f"{name}.ln_2", {k: v[i] for k, v in b["ln_2"].items()})


def _vit(sd: StateDict, vis: Mapping[str, Any], cfg: CLIPConfig) -> None:
    _conv(sd, "visual.conv1", vis["conv1"])
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{name}"] = _t(vis[name])
    _ln(sd, "visual.ln_pre", vis["ln_pre"])
    _blocks(sd, "visual.transformer", vis["transformer"], cfg.vision_layers[0])
    _ln(sd, "visual.ln_post", vis["ln_post"])


def _resnet(sd: StateDict, vis: Mapping[str, Any], cfg: CLIPConfig) -> None:
    for i in (1, 2, 3):
        _conv(sd, f"visual.conv{i}", vis[f"conv{i}"])
        _bn(sd, f"visual.bn{i}", vis[f"bn{i}"])
    for li, blocks in enumerate(cfg.vision_layers, start=1):
        for j in range(blocks):
            p = vis[f"layer{li}"][j]
            name = f"visual.layer{li}.{j}"
            for i in (1, 2, 3):
                _conv(sd, f"{name}.conv{i}", p[f"conv{i}"])
                _bn(sd, f"{name}.bn{i}", p[f"bn{i}"])
            if "downsample" in p:
                _conv(sd, f"{name}.downsample.0", p["downsample"]["conv"])
                _bn(sd, f"{name}.downsample.1", p["downsample"]["bn"])
    ap = vis["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for short, full in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        _linear(sd, f"visual.attnpool.{full}", ap[short])


def from_jax_params(params: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """JAX CLIP pytree (``{"visual", "text", "logit_scale"}``) -> OpenAI
    ``state_dict`` for a ResNet or ViT CLIP."""
    sd: StateDict = {}
    (_vit if cfg.is_vit else _resnet)(sd, params["visual"], cfg)
    txt = params["text"]
    sd["token_embedding.weight"] = _t(txt["token_embedding"])
    sd["positional_embedding"] = _t(txt["positional_embedding"])
    _blocks(sd, "transformer", txt["transformer"], cfg.transformer_layers)
    _ln(sd, "ln_final", txt["ln_final"])
    sd["text_projection"] = _t(txt["text_projection"])
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd
