"""Weight loading: OpenAI CLIP checkpoints, and carry-over from the JAX
package's parameter pytree.

``load_torch_checkpoint`` reads an OpenAI ``.pt`` (a TorchScript archive or a
plain ``state_dict``, as ``hgr_tpu/models/convert.py:208-223`` and the
reference's ``clip/clip.py:112-130`` do) and ``sniff_config`` reads its
architecture from the shapes (``hgr_tpu/models/convert.py:103-157``, the
reference's ``build_model``, ``clip/model.py:395-432``), and EVA-CLIP's
``CustomCLIP`` layout too (``visual.patch_embed``, ``visual.blocks``:
``models/eva_vit.py``; the text tower under ``text.``, which the loader
takes off, since the port keeps OpenAI's top-level names).
The port's modules carry the checkpoints' key names, so loading is
near-identity: tensors become fp32, and BatchNorm's ``num_batches_tracked``
counters, the archive's ``input_resolution``/``context_length``/
``vocab_size`` entries, and what the port derives, EVA's rotary tables
(``visual.rope.freqs_cos`` and ``_sin``, repeated in each block's
``attn.rope``) and a text tower's causal ``attn_mask``, are dropped. No
published EVA-CLIP checkpoint has been read: the layout is held to
EVA-CLIP's key names in the tests.

``from_jax_params`` is the inverse of ``hgr_tpu/models/convert.py:
convert_state_dict`` (``:160-205``): it takes the JAX pytree with numpy (or
array-like) leaves and returns an OpenAI-named ``state_dict`` of fp32 torch
tensors that ``CLIP.load_state_dict`` accepts. It unstacks the scanned
transformer blocks, transposes conv weights HWIO -> OIHW and linear weights
``[in, out]`` -> ``[out, in]``, and repacks ``qkv`` into ``in_proj_weight``.
``from_jax_resnet`` does the same for the baselines' standard ResNet-50.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def from_jax_resnet(params: Mapping[str, Any]) -> StateDict:
    """JAX standard ResNet-50 tree (``hgr_tpu/models/resnet_std.py``) ->
    torchvision ``state_dict`` (the inverse of its ``convert_torch_resnet``,
    ``:184-228``), which ``ResNet50.load_state_dict`` takes; a tree without
    ``fc`` gives no head."""
    sd: StateDict = {}
    _conv(sd, "conv1", params["conv1"])
    _bn(sd, "bn1", params["bn1"])
    for li in range(1, 5):
        for j, p in enumerate(params[f"layer{li}"]):
            name = f"layer{li}.{j}"
            for i in (1, 2, 3):
                _conv(sd, f"{name}.conv{i}", p[f"conv{i}"])
                _bn(sd, f"{name}.bn{i}", p[f"bn{i}"])
            if "downsample" in p:
                _conv(sd, f"{name}.downsample.0", p["downsample"]["conv"])
                _bn(sd, f"{name}.downsample.1", p["downsample"]["bn"])
    if "fc" in params:
        _linear(sd, "fc", params["fc"])
    return sd


# entries of an OpenAI state_dict that are no weights of the model
_NOT_WEIGHTS = ("input_resolution", "context_length", "vocab_size")


def _is_weight(key: str) -> bool:
    return (key not in _NOT_WEIGHTS and not key.endswith(("num_batches_tracked", "attn_mask"))
            and not (key.startswith("visual.") and key.endswith((".freqs_cos", ".freqs_sin"))))


def _openai_name(key: str) -> str:
    """EVA-CLIP's ``CustomCLIP`` name -> the port's: its text tower's
    ``text.`` taken off (``text.transformer.resblocks.0.ln_1.weight`` ->
    ``transformer.resblocks.0.ln_1.weight``); other names unchanged."""
    return key[len("text."):] if key.startswith("text.") else key


def sniff_config(sd: Mapping[str, Any]) -> CLIPConfig:
    """The architecture of an OpenAI- or EVA02-CLIP-layout ``state_dict``,
    from its shapes (``hgr_tpu/models/convert.py:103-157``)."""
    is_vit = "visual.proj" in sd
    embed_dim = sd["text_projection"].shape[1]
    context_length = sd["positional_embedding"].shape[0]
    vocab_size = sd["token_embedding.weight"].shape[0]
    transformer_width = sd["ln_final.weight"].shape[0]
    transformer_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})
    text = dict(embed_dim=embed_dim, context_length=context_length, vocab_size=vocab_size,
                transformer_width=transformer_width,
                transformer_heads=transformer_width // 64,
                transformer_layers=transformer_layers)
    if "visual.patch_embed.proj.weight" in sd:
        conv = sd["visual.patch_embed.proj.weight"]
        grid = round((sd["visual.pos_embed"].shape[1] - 1) ** 0.5)
        vision_layers = len({k.split(".")[2] for k in sd if k.startswith("visual.blocks.")})
        return CLIPConfig(image_resolution=conv.shape[-1] * grid, vision_layers=(vision_layers,),
                          vision_width=conv.shape[0], vision_patch_size=conv.shape[-1],
                          vision_block="eva02",
                          vision_mlp_width=sd["visual.blocks.0.mlp.w1.weight"].shape[0],
                          text_activation="gelu", **text)  # EVA-CLIP's json: no quick_gelu
    if is_vit:
        vision_layers = len(
            {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks")})
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        return CLIPConfig(image_resolution=patch * grid, vision_layers=(vision_layers,),
                          vision_width=sd["visual.conv1.weight"].shape[0],
                          vision_patch_size=patch, **text)
    counts = [len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{i}")})
              for i in (1, 2, 3, 4)]
    grid = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return CLIPConfig(image_resolution=grid * 32, vision_layers=tuple(counts),
                      vision_width=sd["visual.layer1.0.conv1.weight"].shape[0], **text)


def load_torch_checkpoint(path: str) -> Tuple[CLIPConfig, StateDict]:
    """An OpenAI CLIP ``.pt``, or an EVA02-CLIP ``state_dict`` in
    ``CustomCLIP``'s layout, -> (config, fp32 ``state_dict`` on the CPU that
    ``CLIP(config).load_state_dict`` takes). A TorchScript archive is tried
    first, then a pickled ``state_dict`` (or a module holding one)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    sd = {_openai_name(k): v.detach().float() for k, v in sd.items() if _is_weight(k)}
    return sniff_config(sd), sd
