"""The port's hierarchy chains and text front end against the JAX package.

- chains: on hypothesis DAGs with multi-parent nodes, the port's own
  bidirectional search, run with networkx blocked, gives the JAX package's
  chains with networkx; and ``chip_smoke.EXPECTED_CHAINS_SHA256`` is the
  JAX digest of the smoke's 18,278-class hierarchy;
- the tokenizer without ``regex``: ``encode``/``decode`` on hypothesis text
  over the Unicode categories where ``re`` and ``regex`` differ,
  ``tokenize`` (truncation and overflow) and ``load_merges`` from a written
  ``.gz``, all exactly equal;
- the template banks, and ``TreeModel.build`` with a tokenizer and names:
  ``node_tokens``, ``name_token_ids`` and the cut length, exactly equal.

Text is drawn only from code points that this Python's ``unicodedata``
assigns: ``regex`` carries newer Unicode tables, and a code point that only
one of the two versions assigns may split differently.
"""

import sys
import unicodedata
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.hierarchy import Hierarchy as JHierarchy  # noqa: E402
from hgr_tpu.hierarchy import profiled_hierarchy as j_profiled  # noqa: E402
from hgr_tpu.text import bpe as jbpe  # noqa: E402
from hgr_tpu.text import prompts as jprompts  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.tree_model import node_prompts as j_node_prompts  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.hierarchy import Hierarchy, profiled_hierarchy  # noqa: E402
from hgr_tpu_torch.text import bpe, prompts  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel, node_prompts  # noqa: E402

# ---- chains ----------------------------------------------------------------


@st.composite
def dags(draw):
    """Edge lists ``[(parent, child)]`` from the root: levels of 1-5 nodes,
    each node with one to three parents one or two levels up (so shortest
    paths tie), in a drawn order, with a few duplicate edges."""
    n_levels = draw(st.integers(2, 5))
    levels, edges = [["fall11"]], []
    for d in range(n_levels):
        cur = [f"n{d}_{i}" for i in range(draw(st.integers(1, 5)))]
        for v in cur:
            ups = levels[-1] + (levels[-2] if len(levels) > 1 else [])
            k = draw(st.integers(1, min(3, len(ups))))
            for u in draw(st.permutations(ups))[:k]:
                edges.append((u, v))
        levels.append(cur)
    edges = draw(st.permutations(edges))
    return edges + draw(st.lists(st.sampled_from(edges), max_size=3))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(dags())
def test_chains_match_jax_on_dags(edges):
    want = JHierarchy.from_edges(edges)
    with mock.patch.dict(sys.modules, {"networkx": None}):
        got = Hierarchy.from_edges(edges)
    assert got.names == want.names
    for f in ("depth", "ancestors", "child_indptr", "child_indices", "level_members"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_chains_digest_matches_chip_smoke():
    """The digest the smoke asserts on the card is the JAX package's, with
    networkx, and the port's with networkx blocked."""
    want = j_profiled(chip_smoke.LEVEL_SIZES, seed=0, cross_edges=40)
    with mock.patch.dict(sys.modules, {"networkx": None}):
        got = profiled_hierarchy(chip_smoke.LEVEL_SIZES, seed=0, cross_edges=40)
    assert chip_smoke.chains_digest(want) == chip_smoke.EXPECTED_CHAINS_SHA256
    assert chip_smoke.chains_digest(got) == chip_smoke.EXPECTED_CHAINS_SHA256
    assert got.num_nodes == 18278


# ---- tokenizer -------------------------------------------------------------

WORDS = ["a photo of a {}.", "itap of my {}.", "dog", "red fox", "Tiger's", "it'LL", "WE'RE",
         "&amp;", "&lt;b&gt;", "x²", "½ cup", "Ⅻ", "١٢٣", "naïve café", "東京", "ǅemal"]


def _assigned(categories):
    return [chr(c) for c in range(sys.maxunicode + 1)
            if unicodedata.category(chr(c)) in categories]


# the categories where re's shortcuts and regex's properties part, and the
# characters between them: \x1c-\x1f (str.isspace but not regex's \s),
# \x85 and \xa0 (whitespace in both), apostrophes for the contractions
ALPHABET = (_assigned({"Lu", "Ll", "Lo", "Lm", "Lt", "Nd", "Nl", "No", "Mn", "Po", "So"})
            + list("\x1c\x1d\x1e\x1f\x85\xa0\t\n '&;#") + ["ͅ", "　"])
TEXT = st.lists(st.one_of(st.text(st.sampled_from(ALPHABET), max_size=12),
                          st.sampled_from(WORDS + ["'S", "'LL", "'d", "&#39;", "&quot;"])),
                max_size=6).map(" ".join)


@pytest.fixture(scope="module")
def merges():
    return chip_smoke.learn_merges([w.format("dog") for w in WORDS]
                                   + [p.format("red fox") for p in prompts.TEMPLATES_STANDARD], 120)


@pytest.fixture(scope="module")
def tokenizers(merges):
    return bpe.Tokenizer(merges=merges), jbpe.Tokenizer(merges=merges)


@settings(max_examples=300, deadline=None, suppress_health_check=[
    HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(TEXT)
def test_encode_matches_jax(tokenizers, text):
    ours, theirs = tokenizers
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ours.decode(ids) == theirs.decode(ids)
    assert bpe._clean(text) == jbpe._clean(text)


def test_tokenize_and_load_merges_match_jax(tmp_path, merges, tokenizers):
    ours, theirs = tokenizers
    texts = [w.format("gray wolf") for w in WORDS] + ["x " * 40, ""]
    for ctx in (77, 16):
        for truncate in (True, False):
            try:
                want = theirs.tokenize(texts, ctx, truncate=truncate)
            except RuntimeError as e:
                with pytest.raises(RuntimeError, match="too long for context length"):
                    ours.tokenize(texts, ctx, truncate=truncate)
                assert "too long" in str(e)
                continue
            got = ours.tokenize(texts, ctx, truncate=truncate)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.tokenize("dog"), theirs.tokenize("dog"))
    # a merges file longer than CLIP's slice: header, then 49152-258 entries read
    path = str(tmp_path / "merges.txt.gz")
    long = merges + [(f"q{i}", f"z{i}") for i in range(49152 - 258 + 5 - len(merges))]
    chip_smoke.write_merges(path, long)
    got, want = bpe.load_merges(path), jbpe.load_merges(path)
    assert got == want and len(got) == 49152 - 258 and got[: len(merges)] == merges
    a, b = bpe.Tokenizer(path), jbpe.Tokenizer(path)
    assert a.encoder == b.encoder and a.vocab_size == b.vocab_size == 49408
    assert a.encode("a photo of a red fox.") == b.encode("a photo of a red fox.")
    with pytest.raises(FileNotFoundError):
        bpe.load_merges(str(tmp_path / "none.gz"))
    assert bpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


def test_template_banks_match_jax():
    assert prompts.BANKS == jprompts.BANKS
    for name in jprompts.BANKS:
        assert prompts.get_bank(name) == jprompts.get_bank(name)
    assert len(prompts.TEMPLATES_STANDARD) == 80 and len(prompts.TEMPLATES_SELECT) == 7
    with pytest.raises(KeyError, match="unknown template bank"):
        prompts.get_bank("TEMPLATES_NONE")


def test_tree_model_tokens_match_jax(merges):
    """Prompts tokenised at context_length, name ids of ``name + "."``, and
    the bank cut after the longest prompt, for named and unnamed nodes and
    two templates."""
    level_sizes = [3, 12, 30, 40, 20]
    hier, jhier = profiled_hierarchy(level_sizes, seed=1, cross_edges=12), \
        j_profiled(level_sizes, seed=1, cross_edges=12)
    names = chip_smoke.word_names(hier.names[::2], seed=3)
    tok = bpe.Tokenizer(merges=merges)
    jtok = jbpe.Tokenizer(merges=merges)
    for template in ("TEMPLATES_SIMPLE", "TEMPLATES_SELECT"):
        assert node_prompts(hier, template, names) == j_node_prompts(jhier, template, names)
        got = TreeModel.build(Config(arch="TEST-RN", template=template), hier, tokenizer=tok,
                              names=names, pad_multiple=64, device="cpu")
        want = JTreeModel.build(JConfig(arch="TEST-RN", template=template), jhier,
                                tokenizer=jtok, names=names, pad_multiple=64)
        np.testing.assert_array_equal(got.node_tokens, want.node_tokens)
        assert got.name_token_ids == want.name_token_ids
        t_need = int((want.node_tokens == jtok.eot_id).argmax(1).max()) + 1
        assert got.node_tokens.shape[1] == max(16, -(-t_need // 16) * 16) < 77
