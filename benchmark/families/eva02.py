"""EVA02-CLIP (Sun et al. 2023, "EVA-CLIP", arXiv:2303.15389;
``github.com/baaivision/EVA``, ``EVA-CLIP/rei/eva_clip``): EVA-02's vision
transformer (arXiv:2303.11331; ``eva_vit_model.py``) beside OpenAI's causal
text tower with exact GELU, written in plain float32 PyTorch (TF32 off) from
the published description, with no kernels or fused steps. It imports
nothing of the program.

The vision tower, T = grid² + 1 tokens, LayerNorm eps ``vision.ln_eps``:

- ``x = [cls_token; conv(img) + b] + pos_embed`` (no ``ln_pre``);
- a block: ``h = norm1(x)``; ``q = h Wq + q_bias``, ``k = h Wk``,
  ``v = h Wv + v_bias`` in heads of ``vision.head_width``; 2-D rotary
  embedding on rows 1..T-1 of q and k (row 0, the class token, as it is);
  ``a = softmax(q kᵀ / sqrt(Dh)) v``; ``x = x + proj(inner_attn_ln(a))``;
  ``h = norm2(x)``; ``x = x + w3(ffn_ln(SiLU(w1 h) * w2 h))``;
- ``feature = head(norm(x[0]))``.

The rotary is EVA's ``VisionRotaryEmbeddingFast`` with ``intp_freq``:
patch (r, c) takes the position r on the first half of a head's channels
and c on the second; channel pair (2j, 2j+1) of a half turns by
``p (rope_grid / grid) 10000^(-j / (Dh / 4))`` through EVA's interleaved
``rotate_half``, with the tables and the turn in fp32 as EVA computes them.
The text tower is OpenAI's block (``hbench/reference.py``'s names and
attention) with ``F.gelu`` for QuickGELU: EVA-CLIP builds ``nn.GELU``
where the model config has no ``quick_gelu`` key, and
``EVA02-CLIP-L-14.json`` has none.

Departures from EVA-CLIP's code: none in the arithmetic. Its xformers
attention and fused LayerNorms are this plain attention and
``F.layer_norm``; dropout, drop-path and patch dropout are off at
inference and absent here. The weights are drawn (``draw_weights``), not
EVA-CLIP's published ones: EVA's initialisation (normal 0.02, block i's
``attn.proj`` and ``mlp.w3`` divided by ``sqrt(2 (i + 1))``), with the
LayerNorms' scales drawn near one and every bias and shift off zero, so
that each parameter takes part.
"""

import json
import math
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F

from hbench import reference
from hbench.reference import Quant, _attend, _linear, _ln, _pixels, _q
from hbench.work import text_attention_work, text_flops  # noqa: F401
from hbench.work import vit_attention_work

INIT_STD = 0.02
ROPE_THETA = 10000.0


def _heads(v) -> int:
    return v["width"] // v["head_width"]


def param_spec(cfg: Dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind, scale), under the program's (EVA-CLIP's)
    names, in ``hbench/reference.py``'s kinds; the text tower's entries are
    the clip family's."""
    v, embed = cfg["vision"], cfg["embed_dim"]
    W, L, Hd, ps = v["width"], v["layers"], v["mlp_width"], v["patch_size"]
    grid = v["image_resolution"] // ps
    spec: "OrderedDict[str, tuple]" = OrderedDict()

    def lin(name, dout, din, std=INIT_STD, bias=True):
        spec[name + ".weight"] = ((dout, din), "normal", std)
        if bias:
            spec[name + ".bias"] = ((dout,), "normal", 0.02)

    def ln(name, c):
        spec[name + ".weight"] = ((c,), "affine_w", 1.0)
        spec[name + ".bias"] = ((c,), "affine_b", 0.05)

    # PyTorch's default conv init, uniform of bound fan_in^-0.5, has this std
    spec["visual.patch_embed.proj.weight"] = ((W, 3, ps, ps), "normal",
                                              (3 * 3 * ps * ps) ** -0.5)
    spec["visual.patch_embed.proj.bias"] = ((W,), "normal", 0.02)
    spec["visual.cls_token"] = ((1, 1, W), "normal", INIT_STD)
    spec["visual.pos_embed"] = ((1, grid * grid + 1, W), "normal", INIT_STD)
    for i in range(L):
        p = f"visual.blocks.{i}"
        rescale = (2.0 * (i + 1)) ** -0.5
        ln(p + ".norm1", W)
        for n in ("q_proj", "k_proj", "v_proj"):
            lin(f"{p}.attn.{n}", W, W, bias=False)
        spec[p + ".attn.q_bias"] = ((W,), "normal", 0.02)
        spec[p + ".attn.v_bias"] = ((W,), "normal", 0.02)
        ln(p + ".attn.inner_attn_ln", W)
        lin(p + ".attn.proj", W, W, INIT_STD * rescale)
        ln(p + ".norm2", W)
        lin(p + ".mlp.w1", Hd, W)
        lin(p + ".mlp.w2", Hd, W)
        ln(p + ".mlp.ffn_ln", Hd)
        lin(p + ".mlp.w3", W, Hd, INIT_STD * rescale)
    ln("visual.norm", W)
    lin("visual.head", embed, W)
    # the clip family's text tower: its spec over a one-pixel ViT stub, less the stub
    stub = dict(cfg, vision={"patch_size": 1, "width": 1, "layers": 1, "image_resolution": 1})
    spec.update((k, s) for k, s in reference.param_spec(stub).items()
                if not k.startswith("visual."))
    return spec


@torch.no_grad()
def draw_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device``, from one draw of a
    ``torch.Generator`` on that device, as ``hbench/reference.py`` draws."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for shape, _, _ in spec.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, (shape, kind, scale)), n in zip(spec.items(), sizes):
        z = flat[off: off + n].view(shape)
        off += n
        if kind == "affine_w":
            t = scale * (1.0 + 0.1 * z)
        elif kind == "const":
            t = torch.full(shape, scale, device=device)
        else:  # normal, affine_b
            t = z * scale
        out[name] = t.contiguous()
    return out


def rope_tables(cfg: Dict, device):
    """EVA's ``freqs_cos`` and ``freqs_sin``, fp32 [grid², Dh], for the
    patch tokens (the class token takes none)."""
    v = cfg["vision"]
    grid, half = v["image_resolution"] // v["patch_size"], v["head_width"] // 2
    freqs = 1.0 / ROPE_THETA ** (torch.arange(0, half, 2, device=device).float() / half)
    t = torch.arange(grid, device=device) / grid * v["rope_grid"]
    f = torch.einsum("i,f->if", t, freqs).repeat_interleave(2, dim=-1)     # [grid, half]
    f = torch.cat([f[:, None, :].expand(grid, grid, half),
                   f[None, :, :].expand(grid, grid, half)], dim=-1).reshape(grid * grid, -1)
    return f.cos(), f.sin()


def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def _vln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], eps)


def _vision(x, sd, cfg: Dict, quant: Quant):
    v = cfg["vision"]
    W, eps, H = v["width"], v["ln_eps"], _heads(v)
    x = F.conv2d(_q(quant, x), _q(quant, sd["visual.patch_embed.proj.weight"]),
                 bias=sd["visual.patch_embed.proj.bias"], stride=v["patch_size"])
    B = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["visual.cls_token"].expand(B, 1, W), x], dim=1) + sd["visual.pos_embed"]
    T = x.shape[1]
    cos, sin = rope_tables(cfg, x.device)

    def heads(t):
        return t.view(B, T, H, -1).transpose(1, 2)

    def rope(t):
        r = t[:, :, 1:]
        return torch.cat([t[:, :, :1], r * cos + _rotate_half(r) * sin], dim=2)

    for i in range(v["layers"]):
        p = f"visual.blocks.{i}"
        h = _q(quant, _vln(x, sd, p + ".norm1", eps))
        q = F.linear(h, _q(quant, sd[p + ".attn.q_proj.weight"]), sd[p + ".attn.q_bias"])
        k = F.linear(h, _q(quant, sd[p + ".attn.k_proj.weight"]))
        val = F.linear(h, _q(quant, sd[p + ".attn.v_proj.weight"]), sd[p + ".attn.v_bias"])
        q, k, val = rope(heads(q)), rope(heads(k)), heads(val)
        s = torch.matmul(_q(quant, q), _q(quant, k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        a = torch.matmul(_q(quant, torch.softmax(s, dim=-1)), _q(quant, val))
        a = a.transpose(1, 2).reshape(B, T, W)
        x = x + _linear(_vln(a, sd, p + ".attn.inner_attn_ln", eps), sd, p + ".attn.proj", quant)
        h = _vln(x, sd, p + ".norm2", eps)
        g = F.silu(_linear(h, sd, p + ".mlp.w1", quant)) * _linear(h, sd, p + ".mlp.w2", quant)
        x = x + _linear(_vln(g, sd, p + ".mlp.ffn_ln", eps), sd, p + ".mlp.w3", quant)
    return _linear(_vln(x[:, 0], sd, "visual.norm", eps), sd, "visual.head", quant)


def encode_image(sd, cfg: Dict, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, embed] features, unnormalised; the
    images normalised with OpenAI's mean and std, as EVA-CLIP does."""
    return _vision(_pixels(images), sd, cfg, quant)


def encode_text(sd, cfg: Dict, tokens: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[N, T] ids -> [N, embed] features, unnormalised: OpenAI's text tower
    with exact GELU, LayerNorm eps 1e-5."""
    t = cfg["text"]
    T = tokens.shape[1]
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"][:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu_(1)
    D = x.shape[-1]
    for i in range(t["layers"]):
        p = f"transformer.resblocks.{i}"
        qkv = F.linear(_q(quant, _ln(x, sd, p + ".ln_1")),
                       _q(quant, sd[p + ".attn.in_proj_weight"]), sd[p + ".attn.in_proj_bias"])
        q, k, v = qkv.split(D, dim=-1)
        x = x + _linear(_attend(q, k, v, t["heads"], mask, quant), sd, p + ".attn.out_proj",
                        quant)
        h = _linear(_ln(x, sd, p + ".ln_2"), sd, p + ".mlp.c_fc", quant)
        x = x + _linear(F.gelu(h), sd, p + ".mlp.c_proj", quant)
    x = _ln(x, sd, "ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return torch.matmul(_q(quant, x), _q(quant, sd["text_projection"]))


def image_flops(cfg: Dict) -> float:
    """One image: the patch conv, per token and layer the q/k/v/o products
    (4 W²) and the SwiGLU's three (3 W Hd), the attention (4 T² W a layer),
    and the head."""
    v = cfg["vision"]
    W, ps, Hd = v["width"], v["patch_size"], v["mlp_width"]
    n = (v["image_resolution"] // ps) ** 2
    t = n + 1
    per_layer = 2.0 * t * (4 * W * W + 3 * W * Hd) + 4.0 * t * t * W
    return 2.0 * 3 * ps * ps * W * n + v["layers"] * per_layer + 2.0 * W * cfg["embed_dim"]


def image_attention_work(cfg: Dict, images: int):
    """K1 in the image tower: the ViT's count, unmasked at T = grid² + 1."""
    return vit_attention_work(cfg, images)


def tiny(cfg: Dict) -> Dict:
    """``cfg`` at the program's TEST-EVA sizes: vision patch 8 at 32 px,
    width 128 in 2 heads of 64, SwiGLU 341 wide (int(128 x 2.6667)), 2
    layers, the rotary's reference grid kept (16 over a grid of 4); a
    2-layer text tower 32 wide over 512 ids; embedding 64; the class set of
    five levels (the clip family's)."""
    cfg = json.loads(json.dumps(cfg))
    cfg["arch"] = "TEST-EVA"
    cfg["classes"] = {"level_sizes": [3, 12, 30, 40, 20], "hierarchy_seed": 0, "cross_edges": 0,
                      "n_seen": 70, "pad_multiple": 128}
    cfg["text"] = {"context_length": 77, "vocab_size": 512, "width": 32, "heads": 2, "layers": 2}
    cfg["embed_dim"] = 64
    cfg["vision"].update(layers=2, width=128, mlp_width=341, patch_size=8, image_resolution=32)
    return cfg
