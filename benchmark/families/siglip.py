"""SigLIP So400m/14 at 384 px (Zhai et al. 2023, "Sigmoid Loss for Language
Image Pre-Training", arXiv:2303.15343; the SoViT-400m shape of
Alabdulmohsin et al. 2023, arXiv:2305.13035), as ``transformers``'
``models/siglip/modeling_siglip.py`` builds it from
``huggingface.co/google/siglip-so400m-patch14-384``'s ``config.json``,
written in plain float32 PyTorch (TF32 off) from that description, with no
kernels or fused steps. It imports nothing of the program.

Both towers are pre-LN blocks, LayerNorm eps ``ln_eps`` (1e-6), no mask:
``x = x + o(softmax(q kᵀ / sqrt(Dh)) v)`` over ``LN₁(x)`` with q, k and v
from Linears with biases (held packed as ``in_proj``, the program's
names), heads of ``head_width`` (72); ``x = x + fc2(gelu_tanh(fc1(LN₂(x))))``,
``mlp_width`` (4,304) wide, GELU's tanh form.

- Vision, T = grid² tokens (no class token): ``x = conv(img) + b + pos``,
  the patch conv of stride ``patch_size`` leaving the last pixels of each
  side unread (6 of 384 at 14); the blocks; ``y = post_layernorm(x)`` over
  all rows; the MAP head: ``a = MHA(probe, y, y)``
  (``nn.MultiheadAttention``'s packed ``in_proj`` and ``out_proj``),
  ``h = a + mlp(layernorm(a))``, the feature ``h[0]``. Images are
  normalised with mean and std 0.5.
- Text: ``x = tok[ids] + pos``; the blocks; ``final_layer_norm``; the
  feature is the last position's row through ``head`` (a Linear with a
  bias; its weight held as ``text_projection``, [in, out]). Every position
  reaches it, so ``encode_text`` pads the prompts it is given (the harness
  cuts them at their longest EOT) back to ``context_length`` with id 0, as
  the program's bank holds them.

Departures from ``modeling_siglip.py``: none in the arithmetic. Its SDPA
or eager attention is this plain attention, dropout is off at inference
and absent. The weights are drawn (``draw_weights``), not SigLIP's
published ones, with LayerNorm scales near one and every bias off zero so
that each parameter takes part; the prompts are synthetic (SOT and EOT at
the two highest ids, id 0 as pad where SigLIP pads with ``</s>``), since
SigLIP's SentencePiece tokenizer is not in the repository.
"""

import json
import math
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F

from hbench.reference import Quant, _attend, _linear, _q
from hbench.work import BF16_BYTES

MEAN = STD = (0.5, 0.5, 0.5)


def _heads(width: int, head_width: int) -> int:
    return width // head_width


def param_spec(cfg: Dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind, scale), under the program's names, in
    ``hbench/reference.py``'s kinds (``normal``, ``affine_w``, ``affine_b``,
    ``const``); OpenAI's block initialisation at the towers' MLP width."""
    v, t, embed = cfg["vision"], cfg["text"], cfg["embed_dim"]
    spec: "OrderedDict[str, tuple]" = OrderedDict()

    def ln(name, c):
        spec[name + ".weight"] = ((c,), "affine_w", 1.0)
        spec[name + ".bias"] = ((c,), "affine_b", 0.05)

    def lin(name, dout, din, std):
        spec[name + ".weight"] = ((dout, din), "normal", std)
        spec[name + ".bias"] = ((dout,), "normal", 0.02)

    def mha(name, width, proj_std):
        spec[name + ".in_proj_weight"] = ((3 * width, width), "normal", width ** -0.5)
        spec[name + ".in_proj_bias"] = ((3 * width,), "normal", 0.02)
        lin(name + ".out_proj", width, width, proj_std)

    def blocks(prefix, width, layers, hidden):
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            mha(p + ".attn", width, proj_std)
            ln(p + ".ln_1", width)
            lin(p + ".mlp.c_fc", hidden, width, (2 * width) ** -0.5)
            lin(p + ".mlp.c_proj", width, hidden, proj_std)
            ln(p + ".ln_2", width)

    W, ps = v["width"], v["patch_size"]
    grid = v["image_resolution"] // ps
    spec["visual.conv1.weight"] = ((W, 3, ps, ps), "normal", W ** -0.5)
    spec["visual.conv1.bias"] = ((W,), "normal", 0.02)
    spec["visual.positional_embedding"] = ((grid * grid, W), "normal", W ** -0.5)
    blocks("visual.transformer", W, v["layers"], v["mlp_width"])
    ln("visual.post_layernorm", W)
    spec["visual.attn_pool.probe"] = ((1, 1, W), "normal", W ** -0.5)
    mha("visual.attn_pool.attn", W, W ** -0.5)
    ln("visual.attn_pool.layernorm", W)
    lin("visual.attn_pool.mlp.c_fc", v["mlp_width"], W, W ** -0.5)
    lin("visual.attn_pool.mlp.c_proj", W, v["mlp_width"], v["mlp_width"] ** -0.5)

    tw = t["width"]
    blocks("transformer", tw, t["layers"], t["mlp_width"])
    spec["token_embedding.weight"] = ((t["vocab_size"], tw), "normal", 0.02)
    spec["positional_embedding"] = ((t["context_length"], tw), "normal", 0.01)
    ln("ln_final", tw)
    spec["text_projection"] = ((tw, embed), "normal", tw ** -0.5)
    spec["text_projection_bias"] = ((embed,), "normal", 0.02)
    spec["logit_scale"] = ((), "const", math.log(10.0))
    spec["logit_bias"] = ((), "const", -10.0)
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


def _ln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], eps)


def _mlp(h, sd, name, quant: Quant):
    h = _linear(h, sd, name + ".c_fc", quant)
    return _linear(F.gelu(h, approximate="tanh"), sd, name + ".c_proj", quant)


def _blocks(x, sd, prefix: str, layers: int, heads: int, eps: float, quant: Quant):
    D = x.shape[-1]
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        qkv = F.linear(_q(quant, _ln(x, sd, p + ".ln_1", eps)),
                       _q(quant, sd[p + ".attn.in_proj_weight"]), sd[p + ".attn.in_proj_bias"])
        q, k, v = qkv.split(D, dim=-1)
        x = x + _linear(_attend(q, k, v, heads, None, quant), sd, p + ".attn.out_proj", quant)
        x = x + _mlp(_ln(x, sd, p + ".ln_2", eps), sd, p + ".mlp", quant)
    return x


def _pixels(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3, H, W] float32, normalised with SigLIP's
    mean and std."""
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    return ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


def encode_image(sd, cfg: Dict, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, embed] features, unnormalised."""
    v = cfg["vision"]
    W, eps, H = v["width"], v["ln_eps"], _heads(v["width"], v["head_width"])
    x = F.conv2d(_q(quant, _pixels(images)), _q(quant, sd["visual.conv1.weight"]),
                 bias=sd["visual.conv1.bias"], stride=v["patch_size"])
    B = x.shape[0]
    x = x.flatten(2).transpose(1, 2) + sd["visual.positional_embedding"]
    x = _blocks(x, sd, "visual.transformer", v["layers"], H, eps, quant)
    y = _ln(x, sd, "visual.post_layernorm", eps)
    # the MAP head: one learned query over every row
    p = "visual.attn_pool"
    w, b = sd[p + ".attn.in_proj_weight"], sd[p + ".attn.in_proj_bias"]
    q = F.linear(_q(quant, sd[p + ".probe"].expand(B, 1, W)), _q(quant, w[:W]), b[:W])
    kv = F.linear(_q(quant, y), _q(quant, w[W:]), b[W:])
    k, val = kv.split(W, dim=-1)
    a = _linear(_attend(q, k, val, H, None, quant), sd, p + ".attn.out_proj", quant)
    h = a + _mlp(_ln(a, sd, p + ".layernorm", eps), sd, p + ".mlp", quant)
    return h[:, 0]


def encode_text(sd, cfg: Dict, tokens: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[N, T] ids -> [N, embed] features, unnormalised: the prompts padded
    back to ``context_length`` with id 0, the blocks without a mask, the
    last position's row through the head."""
    t = cfg["text"]
    ctx = t["context_length"]
    tokens = F.pad(tokens, (0, ctx - tokens.shape[1]))
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    x = _blocks(x, sd, "transformer", t["layers"], _heads(t["width"], t["head_width"]),
                t["ln_eps"], quant)
    x = _ln(x, sd, "ln_final", t["ln_eps"])[:, -1]
    return torch.matmul(_q(quant, x), _q(quant, sd["text_projection"])) + \
        sd["text_projection_bias"]


def _block_flops(tokens: float, width: int, hidden: int, entries: float) -> float:
    """One block: q, k, v and o (4 W²) and the MLP (2 W Hd) over ``tokens``,
    the attention's two products over ``entries`` (query, key) pairs."""
    return 2.0 * tokens * (4 * width * width + 2 * width * hidden) + 4.0 * entries * width


def image_flops(cfg: Dict) -> float:
    """One image: the patch conv, per layer the block at T = grid² with
    every pair attended, and the MAP head (q of one row, k and v of T rows,
    one query's attention, o and the MLP of one row); nothing for the
    head's LayerNorm or the activations."""
    v = cfg["vision"]
    W, ps, Hd = v["width"], v["patch_size"], v["mlp_width"]
    t = (v["image_resolution"] // ps) ** 2
    conv = 2.0 * 3 * ps * ps * W * t
    head = 2.0 * (W * W + t * 2 * W * W + 2 * t * W + W * W + 2 * W * Hd)
    return conv + v["layers"] * _block_flops(t, W, Hd, t * t) + head


def text_flops(cfg: Dict, lengths) -> float:
    """The text tower over ``len(lengths)`` prompts, each at every one of
    its ``context_length`` positions (no mask: padding reaches the
    feature), and the head."""
    t = cfg["text"]
    n, T, W = len(lengths), t["context_length"], t["width"]
    return n * (t["layers"] * _block_flops(T, W, t["mlp_width"], T * T)
                + 2.0 * W * cfg["embed_dim"])


def _attention_work(width: int, T: int, layers: int, count: int) -> Dict[str, float]:
    """K1 over ``count`` sequences of T rows in every layer, no mask, at the
    model's head width: the kernel's zero columns are not counted."""
    return {"flops": 4.0 * width * T * T * layers * count,
            "bytes": 4.0 * T * width * BF16_BYTES * layers * count}


def image_attention_work(cfg: Dict, images: int) -> Dict[str, float]:
    """K1 in the image tower: T = grid² (no class token); the MAP head's
    one query is plain attention, not K1."""
    v = cfg["vision"]
    t = (v["image_resolution"] // v["patch_size"]) ** 2
    return _attention_work(v["width"], t, v["layers"], images)


def text_attention_work(cfg: Dict, lengths) -> Dict[str, float]:
    """K1 in one bank build: every prompt at ``context_length`` rows."""
    t = cfg["text"]
    return _attention_work(t["width"], t["context_length"], t["layers"], len(lengths))


def tiny(cfg: Dict) -> Dict:
    """``cfg`` at the program's TEST-SIGLIP sizes: both towers 144 wide in
    2 heads of 72 (the head width kept), MLP 538, 2 layers; patch 8 at 32
    px (T = 16); text 16 positions over 512 ids; embedding 144; the class
    set of five levels."""
    cfg = json.loads(json.dumps(cfg))
    cfg["arch"] = "TEST-SIGLIP"
    cfg["classes"] = {"level_sizes": [3, 12, 30, 40, 20], "hierarchy_seed": 0, "cross_edges": 0,
                      "n_seen": 70, "pad_multiple": 128}
    cfg["embed_dim"] = 144
    cfg["vision"].update(layers=2, width=144, mlp_width=538, patch_size=8, image_resolution=32)
    cfg["text"].update(context_length=16, vocab_size=512, width=144, layers=2, mlp_width=538)
    return cfg
