"""TreeModel: the hierarchy-aware CLIP bundle (port of
``hgr_tpu/tree_model.py``).

Counterpart of the reference's ``tree_model`` (``model/clip_tree.py:
19-333``): the CLIP config and model, the hierarchy tables (built in numpy
exactly as ``TreeModel.build`` builds them, copied to the device once), and
the tokenised per-node prompts. It exposes the class bank
(``update_classifier``), its depth-sorted permutation (``sort_bank``) and
the depth-sorted eval step (``eval_step_sorted``). Both run without
gradients on the current weights, so on the card the bank and the ViT run
the fused attention kernel, during training too.

``model`` and ``layer_weight`` (the adaptive per-depth loss weight, fp32,
initialised ``1/|layer d| * scale``) are the train state's own tensors:
``train.init_train_state`` takes them by reference and the train step
updates them in place. In the reference ``layer_weight`` never trains
(``model/clip_tree.py:74`` builds a non-leaf tensor); the JAX package, and
so the port, train it.

Node prompts are a class name in the first template of ``--template``'s
bank, BPE-tokenised (``node_prompts``, ``text/``), or, without a tokenizer,
the synthetic ones (``synthetic_tokens``). Either way the token bank is cut
after the longest prompt's EOT, to a multiple of 16.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .device import select_device
from .eval.bank import bank_logits, build_bank, pad_to, pad_tokens
from .eval.metrics import BatchMetrics, metrics_from_preds
from .hierarchy import Hierarchy
from .models.clip import CLIP, CLIPConfig, clip_init, encode_image, encode_text, get_config
from .ops.attention import attention
from .ops.bank_topk import level_argmax_sorted
from .text import Tokenizer, get_bank

PAD = -1


def node_prompts(
    hier: Hierarchy,
    template: str,
    names: Optional[Dict[str, str]] = None,
) -> List[str]:
    """Per-node prompt strings (reference ``model/clip_tree.py:52-60``): the
    node's name (its wnid where ``names`` has none) in the bank's first
    template."""
    tpl = get_bank(template)[0]
    return [tpl.format((names or {}).get(wnid, wnid)) for wnid in hier.names]


def synthetic_tokens(
    n: int, context_length: int, vocab_size: int, seed: int = 0,
    max_body: int = 18,
) -> np.ndarray:
    """Deterministic pseudo-prompts (no BPE vocab needed): SOT + 4..max_body
    class-specific ids + EOT, lengths like real "a photo of a {}." prompts."""
    rng = np.random.default_rng(seed)
    max_body = min(max_body, context_length - 3)
    toks = np.zeros((n, context_length), np.int32)
    toks[:, 0] = vocab_size - 2
    lens = rng.integers(4, max_body + 1, size=n)
    body = rng.integers(1, vocab_size - 2, size=(n, max_body))
    cols = np.arange(max_body)[None, :]
    toks[:, 1: 1 + max_body] = np.where(cols < lens[:, None], body, 0)
    toks[np.arange(n), 1 + lens] = vocab_size - 1
    return toks


@dataclass
class TreeModel:
    config: Config
    clip_cfg: CLIPConfig
    hier: Hierarchy
    device: torch.device
    n_pad: int
    node_tokens: np.ndarray      # [N_pad, T] int32
    node_depth: np.ndarray       # [N_pad] int32, PAD rows = -1
    chains: np.ndarray           # [N, Lmax] chain_with_self, PAD-filled
    chain_len: np.ndarray        # [N] int32
    train_index: np.ndarray      # ids of candidate classes (reference 'all')
    test_index: np.ndarray       # ids of unseen classes (reference 'rest')
    train_mask: np.ndarray       # [N_pad] bool
    test_mask: np.ndarray        # [N_pad] bool
    layer_weight: torch.Tensor   # [n_levels] fp32 adaptive per-depth weight (trainable)
    depth_order: np.ndarray      # [N_pad] sorted-pos -> global node id
    level_offsets: Tuple[int, ...]  # start offset of each depth (+ end)
    model: Optional[CLIP] = None
    name_token_ids: Optional[List[List[int]]] = None  # per-node class-name BPE ids
    coop_ctx: Optional[torch.Tensor] = None  # trained CoOp context, from run_train or --load

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(
        cls,
        config: Config,
        hier: Hierarchy,
        candidates_train: Optional[list] = None,
        candidates_test: Optional[list] = None,
        tokenizer: Optional[Tokenizer] = None,
        names: Optional[Dict[str, str]] = None,
        pad_multiple: int = 1024,
        seed: int = 0,
        device=None,
    ) -> "TreeModel":
        """Tables as ``hgr_tpu.TreeModel.build`` makes them
        (``hgr_tpu/tree_model.py:103-204``): prompts from ``tokenizer`` and
        ``names`` when a tokenizer is given, else synthetic ones;
        ``device`` defaults to ``cuda:{config.device}``."""
        dev = select_device(device, config.device)
        clip_cfg = get_config(config.arch)
        n = hier.num_nodes
        n_pad = pad_to(n, pad_multiple)
        if tokenizer is not None:
            tokens = tokenizer.tokenize(node_prompts(hier, config.template, names),
                                        clip_cfg.context_length)
            name_token_ids = [tokenizer.encode((names or {}).get(w, w) + ".")
                              for w in hier.names]
        else:
            tokens = synthetic_tokens(n, clip_cfg.context_length, clip_cfg.vocab_size, seed)
            # synthetic "names": the body ids between SOT and EOT
            name_token_ids = [list(map(int, tokens[i, 1: int(tokens[i].argmax())]))
                              for i in range(n)]
        tokens = pad_tokens(tokens, n_pad)
        # exact token-bank truncation: with a causal mask and EOT pooling,
        # positions past a prompt's EOT never reach its feature; cut the
        # all-padding tail to a multiple of 16 (tree_model.py:136-147)
        t_need = int(tokens.argmax(axis=1).max()) + 1
        t_trunc = min(clip_cfg.context_length, max(16, ((t_need + 15) // 16) * 16))
        tokens = np.ascontiguousarray(tokens[:, :t_trunc])

        depth = np.full(n_pad, PAD, np.int32)
        depth[:n] = hier.depth

        lmax = hier.max_chain + 1
        chains = np.full((n, lmax), PAD, np.int32)
        chain_len = np.zeros(n, np.int32)
        for i in range(n):
            c = hier.chain_with_self(i)
            chains[i, : len(c)] = c
            chain_len[i] = len(c)

        all_ids = np.arange(n, dtype=np.int32)
        train_ids = all_ids if candidates_train is None else hier.ids(candidates_train)
        test_ids = all_ids if candidates_test is None else hier.ids(candidates_test)
        train_mask = np.zeros(n_pad, bool)
        train_mask[train_ids] = True
        test_mask = np.zeros(n_pad, bool)
        test_mask[test_ids] = True

        n_levels = hier.max_depth + 1
        layer_weight = (1.0 / hier.level_sizes.astype(np.float32)) * config.scale

        # depth-sorted permutation: stable, so within a depth the global-id
        # order (and with it the argmax tie rule) is kept; pads last
        sort_key = np.where(depth < 0, np.iinfo(np.int32).max, depth)
        depth_order = np.argsort(sort_key, kind="stable").astype(np.int32)
        offsets = [0]
        for d in range(n_levels):
            offsets.append(offsets[-1] + int((hier.depth == d).sum()))

        return cls(
            config=config,
            clip_cfg=clip_cfg,
            hier=hier,
            device=dev,
            n_pad=n_pad,
            node_tokens=tokens,
            node_depth=depth,
            chains=chains,
            chain_len=chain_len,
            train_index=train_ids,
            test_index=test_ids,
            train_mask=train_mask,
            test_mask=test_mask,
            layer_weight=torch.as_tensor(layer_weight, dtype=torch.float32, device=dev),
            depth_order=depth_order,
            level_offsets=tuple(offsets),
            name_token_ids=name_token_ids,
        )

    # ---- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> CLIP:
        g = torch.Generator().manual_seed(seed)
        self.model = clip_init(self.clip_cfg, g, self.device).eval()
        return self.model

    def load_torch(self, path: str) -> CLIP:
        """Weights from an OpenAI CLIP ``.pt`` (TorchScript archive or plain
        ``state_dict``); the architecture is read from the file's shapes and
        replaces ``clip_cfg``, as ``hgr_tpu.TreeModel.load_torch`` does."""
        from .models.convert import load_torch_checkpoint

        cfg, sd = load_torch_checkpoint(path)
        self.clip_cfg = cfg
        self.model = CLIP(cfg).to(self.device).eval()
        self.model.load_state_dict(sd)
        return self.model

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load OpenAI-named weights (e.g. ``models.convert.from_jax_params``)."""
        if self.model is None:
            self.model = CLIP(self.clip_cfg).to(self.device).eval()
        self.model.load_state_dict(sd)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.dtype == "bfloat16" else torch.float32

    # ---- bank ------------------------------------------------------------
    def update_classifier(self, attn_fn=attention) -> torch.Tensor:
        """Encode all node prompts -> normalised [N_pad, D] bank (reference
        ``update_classifier``, ``model/clip_tree.py:318-325``). ``attn_fn``
        replaces the fused attention only where a check compares the two."""
        tokens = torch.as_tensor(self.node_tokens, device=self.device)
        return build_bank(
            tokens,
            lambda tk: encode_text(self.model, tk, dtype=self.dtype, attn_fn=attn_fn),
            chunk=min(512, self.n_pad),
            out_dtype=self.dtype,
        )

    # ---- CoOp variant ----------------------------------------------------
    def coop_setup(self, seed: int = 0):
        """The CoOp prompt layout over all ``n_pad`` rows (pad rows take the
        name ``[0]``) and a fresh context drawn from ``seed``
        (``hgr_tpu/tree_model.py:304-323``)."""
        from .models.coop import build_coop_static, coop_ctx_init

        cfg = self.clip_cfg
        ids = list(self.name_token_ids) + [[0]] * (self.n_pad - len(self.name_token_ids))
        static = build_coop_static(ids, cfg.context_length, sot_id=cfg.vocab_size - 2,
                                   eot_id=cfg.vocab_size - 1, n_ctx=self.config.n_ctx,
                                   position=self.config.class_token_position)
        ctx = coop_ctx_init(torch.Generator().manual_seed(seed), self.config.n_ctx,
                            cfg.transformer_width, self.device)
        return static, ctx

    def coop_text_fn(self, static, remat: Optional[bool] = None, attn_fn=attention):
        """``text_fn(params, ids)`` of the prompt learner on this model's
        device; ``remat`` defaults to the config's."""
        from .models.coop import make_coop_text_fn

        return make_coop_text_fn(static, dtype=self.dtype,
                                 remat=self.config.remat if remat is None else remat,
                                 attn_fn=attn_fn, device=self.device)

    def sort_bank(self, bank: torch.Tensor) -> torch.Tensor:
        """Permute a [N_pad, D] bank into depth-sorted class order (once per
        bank refresh, outside the per-batch step)."""
        return bank[torch.as_tensor(self.depth_order, device=bank.device, dtype=torch.long)]

    # ---- depth-sorted eval step -----------------------------------------
    @functools.cached_property
    def _sorted_tables(self) -> Dict[str, torch.Tensor]:
        """Device tables of the sorted step, made once."""
        dev = self.device
        order = self.depth_order
        train_s = self.train_mask[order]
        offsets = self.level_offsets
        # per level: does a train node OUTSIDE the level exist? (the
        # reference's -1 fill competitor, main.py:169-171); TOR slot False
        total_train = int(train_s.sum())
        fill_outside = [
            total_train - int(train_s[offsets[d]: offsets[d + 1]].sum()) > 0
            for d in range(len(offsets) - 1)
        ] + [False]
        chains = self.chains
        levels = np.where(chains >= 0, self.hier.depth[np.maximum(chains, 0)], 0)

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        return {
            "order": t(order, torch.long),
            "train_s": t(train_s),
            "test_s": t(self.test_mask[order]),
            "fill_outside": t(fill_outside),
            "chains": t(chains, torch.long),
            "chain_len": t(self.chain_len, torch.long),
            "chain_levels": t(levels, torch.long),
        }

    @torch.inference_mode()
    def eval_step_sorted(
        self, bank_sorted: torch.Tensor, images: torch.Tensor, target: int,
        valid: Optional[torch.Tensor] = None,
    ) -> BatchMetrics:
        """One single-class batch against the depth-sorted bank from
        :meth:`sort_bank`: all per-level constrained argmaxes from one pass
        over the logits."""
        return self.metrics_sorted(bank_sorted, encode_image(self.model, images, dtype=self.dtype),
                                   target, valid)

    @torch.inference_mode()
    def metrics_sorted(
        self, bank_sorted: torch.Tensor, feats: torch.Tensor, target: int,
        valid: Optional[torch.Tensor] = None,
    ) -> BatchMetrics:
        """:meth:`eval_step_sorted` from the batch's image features."""
        tb = self._sorted_tables
        logits_s = bank_logits(feats, bank_sorted)
        preds_s, vals = level_argmax_sorted(logits_s, self.level_offsets, tb["train_s"])
        preds_global = tb["order"][preds_s.long()]
        return metrics_from_preds(
            preds_global, logits_s, tb["order"], target, tb["chains"][target],
            tb["chain_len"][target], tb["chain_levels"][target], tb["test_s"],
            valid=valid, lvl_vals=vals, fill_outside=tb["fill_outside"],
        )
