"""Weight loading: OpenAI CLIP checkpoints, and carry-over from the JAX
package's parameter pytree.

``load_torch_checkpoint`` reads an OpenAI ``.pt`` (a TorchScript archive or a
plain ``state_dict``, as ``hgr_tpu/models/convert.py:208-223`` and the
reference's ``clip/clip.py:112-130`` do) and ``sniff_config`` reads its
architecture from the shapes (``hgr_tpu/models/convert.py:103-157``, the
reference's ``build_model``, ``clip/model.py:395-432``), and EVA-CLIP's
``CustomCLIP`` layout too (``visual.patch_embed``, ``visual.blocks``:
``models/eva_vit.py``; the text tower under ``text.``, which the loader
takes off, since the port keeps OpenAI's top-level names), and
``transformers``' ``SiglipModel`` layout (``vision_model.*``,
``text_model.*``, ``logit_bias``; ``_siglip_names`` maps it onto the
port's names, fusing each attention's q, k and v into ``in_proj``; of
SigLIP the sniffer takes So400m/14 at 384 px only, since the file holds
neither the head width nor the image size). ``read_state_dict`` is the
reading without the sniffing. The port's modules carry the checkpoints' key names, so loading is
near-identity: tensors become fp32, and BatchNorm's ``num_batches_tracked``
counters, the archive's ``input_resolution``/``context_length``/
``vocab_size`` entries, and what the port derives, EVA's rotary tables
(``visual.rope.freqs_cos`` and ``_sin``, repeated in each block's
``attn.rope``), a text tower's causal ``attn_mask`` and SigLIP's
``position_ids``, are dropped. No published EVA-CLIP or SigLIP checkpoint
has been read: the layouts are held to their key names in the tests.

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

from .clip import SIGLIP_SO400M, CLIPConfig

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
    return (key not in _NOT_WEIGHTS
            and not key.endswith(("num_batches_tracked", "attn_mask", "position_ids"))
            and not (key.startswith("visual.") and key.endswith((".freqs_cos", ".freqs_sin"))))


def _openai_name(key: str) -> str:
    """EVA-CLIP's ``CustomCLIP`` name -> the port's: its text tower's
    ``text.`` taken off (``text.transformer.resblocks.0.ln_1.weight`` ->
    ``transformer.resblocks.0.ln_1.weight``); other names unchanged."""
    return key[len("text."):] if key.startswith("text.") else key


# SiglipModel's names (transformers, models/siglip/modeling_siglip.py) -> the
# port's: whole keys, then a block's (or the MAP head's) part after its
# prefix; q, k and v are fused apart (_siglip_names)
_SIGLIP_TOP = {
    "text_model.embeddings.token_embedding.weight": "token_embedding.weight",
    "text_model.embeddings.position_embedding.weight": "positional_embedding",
    "text_model.final_layer_norm.weight": "ln_final.weight",
    "text_model.final_layer_norm.bias": "ln_final.bias",
    "text_model.head.bias": "text_projection_bias",
    "vision_model.embeddings.patch_embedding.weight": "visual.conv1.weight",
    "vision_model.embeddings.patch_embedding.bias": "visual.conv1.bias",
    "vision_model.embeddings.position_embedding.weight": "visual.positional_embedding",
    "vision_model.post_layernorm.weight": "visual.post_layernorm.weight",
    "vision_model.post_layernorm.bias": "visual.post_layernorm.bias",
}
_SIGLIP_PREFIX = {"text_model.encoder.layers.": "transformer.resblocks.",
                  "vision_model.encoder.layers.": "visual.transformer.resblocks.",
                  "vision_model.head.": "visual.attn_pool."}
_SIGLIP_PART = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
                "mlp.fc2": "mlp.c_proj", "self_attn.out_proj": "attn.out_proj",
                "attention": "attn"}


def _siglip_part(rest: str) -> str:
    for a, b in _SIGLIP_PART.items():
        if rest.startswith(a + "."):
            return b + rest[len(a):]
    return rest


def _siglip_names(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A ``SiglipModel`` state dict under the port's names: each block's
    ``self_attn.{q,k,v}_proj`` concatenated into ``attn.in_proj_weight`` and
    ``_bias`` (``nn.MultiheadAttention``'s packing, which the MAP head's
    ``attention`` already has), the text ``head`` Linear's weight transposed
    into ``text_projection`` ([in, out], as OpenAI's), ``logit_scale`` and
    ``logit_bias`` ([1] in the file) as scalars."""
    out: StateDict = {}
    for k, v in sd.items():
        if k in _SIGLIP_TOP:
            out[_SIGLIP_TOP[k]] = v
        elif k == "text_model.head.weight":
            out["text_projection"] = v.t().contiguous()
        elif k in ("logit_scale", "logit_bias"):
            out[k] = v.reshape(())
        elif ".self_attn." in k and k.split(".")[-2] in ("q_proj", "k_proj", "v_proj"):
            block, kind = k[: k.index(".self_attn.")], k.split(".")[-1]
            pre = next(p for p in _SIGLIP_PREFIX if block.startswith(p))
            name = f"{_SIGLIP_PREFIX[pre]}{block[len(pre):]}.attn.in_proj_{kind}"
            if name not in out:
                a = f"{block}.self_attn."
                out[name] = torch.cat([sd[f"{a}{n}_proj.{kind}"] for n in "qkv"])
        else:
            pre = next((p for p in _SIGLIP_PREFIX if k.startswith(p)), None)
            if pre is None:
                raise KeyError(f"no port name for SigLIP's {k}")
            rest = k[len(pre):]
            if pre.endswith("layers."):
                i, rest = rest.split(".", 1)
                rest = f"{i}.{_siglip_part(rest)}"
            out[_SIGLIP_PREFIX[pre] + _siglip_part(rest)] = v
    return out


def sniff_config(sd: Mapping[str, Any]) -> CLIPConfig:
    """The architecture of an OpenAI-, EVA02-CLIP- or SigLIP-layout
    ``state_dict`` (SigLIP's under the port's names, ``_siglip_names``),
    from its shapes (``hgr_tpu/models/convert.py:103-157``)."""
    if "visual.attn_pool.probe" in sd:
        return _sniff_siglip(sd)
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


def _siglip_shapes(sd: Mapping[str, Any]) -> Dict[str, int]:
    """A SigLIP state dict's geometry, under the port's names."""
    def layers(prefix):
        n = prefix.count(".")
        return len({k.split(".")[n] for k in sd if k.startswith(prefix)})

    conv = sd["visual.conv1.weight"]
    return dict(
        width=conv.shape[0], patch=conv.shape[-1],
        positions=sd["visual.positional_embedding"].shape[0],
        layers=layers("visual.transformer.resblocks."),
        mlp=sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        text_width=sd["ln_final.weight"].shape[0], text_layers=layers("transformer.resblocks."),
        text_mlp=sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        context=sd["positional_embedding"].shape[0], vocab=sd["token_embedding.weight"].shape[0],
        embed=sd["text_projection"].shape[1])


def _sniff_siglip(sd: Mapping[str, Any]) -> CLIPConfig:
    """SigLIP So400m/14 at 384 px (``clip.SIGLIP_SO400M``), the one SigLIP
    tower the port reads. A SigLIP state dict holds neither its head width
    nor its image size (a stride of 14 leaves 6 of 384 px unread), so any
    other shapes are refused, named, rather than guessed."""
    c = SIGLIP_SO400M
    want = dict(width=c.vision_width, patch=c.vision_patch_size,
                positions=(c.image_resolution // c.vision_patch_size) ** 2,
                layers=c.vision_layers[0], mlp=c.vision_mlp_width,
                text_width=c.transformer_width, text_layers=c.transformer_layers,
                text_mlp=c.text_mlp_width, context=c.context_length, vocab=c.vocab_size,
                embed=c.embed_dim)
    found = _siglip_shapes(sd)
    if found != want:
        raise ValueError(f"the port reads SigLIP So400m/14 at 384 px only ({want}); "
                         f"this state dict has {found}")
    return c


def read_state_dict(path: str) -> StateDict:
    """An OpenAI CLIP ``.pt``, an EVA02-CLIP ``state_dict`` in
    ``CustomCLIP``'s layout, or a SigLIP one in ``SiglipModel``'s, as an
    fp32 ``state_dict`` on the CPU under the port's names. A TorchScript
    archive is tried first, then a pickled ``state_dict`` (or a module
    holding one)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    sd = {k: v.detach().float() for k, v in sd.items() if _is_weight(k)}
    if "vision_model.embeddings.patch_embedding.weight" in sd:
        sd = _siglip_names(sd)
    return {_openai_name(k): v for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Tuple[CLIPConfig, StateDict]:
    """``read_state_dict`` and its config (``sniff_config``): what
    ``CLIP(config).load_state_dict`` takes."""
    sd = read_state_dict(path)
    return sniff_config(sd), sd
