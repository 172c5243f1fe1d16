#!/usr/bin/env python3
"""Where the port's BPE tokenizer spends host time, on the smoke's prompts.

    python3 tools/profile_torch_tokenizer.py [--merges 400]

Builds what ``chip_smoke.py``'s real-input phase tokenizes: the 18,278
prompts of the profiled hierarchy with seeded word-like names, and a merge
table learned from them. Then, on this host, it times one ``tokenize`` call
over all prompts with a fresh tokenizer, the ``name + "."`` encode pass that
``TreeModel.build`` makes after it, and the parts of ``encode`` apart: text
cleanup, the word split and the BPE merges with the id lookup. It also
times the cleanup as it was before ftfy was looked up once, trying
``import ftfy`` for every text, on the same prompts. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
import unicodedata

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _clean_probing_ftfy(text: str) -> str:
    """The cleanup as it was: a failed ``import ftfy`` for every text."""
    import html

    from hgr_tpu_torch.text.bpe import _patterns

    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return _patterns()[1].sub(" ", text.strip()).lower()


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next(x.split(":", 1)[1].strip() for x in f if x.startswith("model name"))
    except (OSError, StopIteration):
        return platform.processor() or platform.machine()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--merges", type=int, default=400)
    args = ap.parse_args()

    import chip_smoke
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.text import bpe
    from hgr_tpu_torch.tree_model import node_prompts

    hier = profiled_hierarchy(chip_smoke.LEVEL_SIZES, seed=0, cross_edges=40)
    names = chip_smoke.word_names(hier.names, seed=0)
    prompts = node_prompts(hier, Config().template, names)
    t0 = time.perf_counter()
    merges = chip_smoke.learn_merges(prompts, args.merges)
    learn_s = time.perf_counter() - t0
    print(f"host: {_cpu()}, {os.cpu_count()} cores, Python {platform.python_version()}, "
          f"{len(sys.path)} sys.path entries; {len(prompts)} prompts, {len(merges)} merges "
          f"learned in {learn_s:.1f} s", flush=True)

    out = {"prompts": len(prompts)}
    tok = bpe.Tokenizer(merges=merges)
    out["tokenize_ms"] = _ms(lambda: tok.tokenize(prompts, 77))
    out["name_encode_ms"] = _ms(lambda: [tok.encode(names[w] + ".") for w in hier.names])

    # the parts of encode, with a fresh tokenizer (an empty BPE cache)
    tok = bpe.Tokenizer(merges=merges)
    words_re = bpe._patterns()[0]
    cleaned, split = [], []
    out["clean_ms"] = _ms(lambda: cleaned.extend(bpe._clean(p) for p in prompts))
    out["split_ms"] = _ms(lambda: split.extend(words_re.findall(c) for c in cleaned))

    def merge_all():
        for words in split:
            for w in words:
                b = "".join(tok.byte_encoder[x] for x in w.encode("utf-8"))
                [tok.encoder[piece] for piece in tok._bpe(b).split(" ")]

    out["bpe_ms"] = _ms(merge_all)
    out["clean_probing_ftfy_ms"] = _ms(lambda: [_clean_probing_ftfy(p) for p in prompts])
    assert [_clean_probing_ftfy(p) for p in prompts[:100]] == cleaned[:100]
    for k, v in out.items():
        if k.endswith("_ms"):
            print(f"{k:>22}: {v:10.1f} ms ({v * 1e3 / len(prompts):.1f} us a prompt)")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
