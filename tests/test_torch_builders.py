"""The port's offline builders (``hgr_tpu_torch/hierarchy/builder.py``,
``hgr_tpu_torch/data/splits.py``) against the JAX package's, on the same
inputs: every edge list, split and manifest equal, in order.

- ``chip_smoke.py``'s seeded ``structure_release.xml`` (a DAG of synsets
  repeated under several parents, a misc subtree whose food subtree is
  re-attached, as ``tests/test_xml_builder.py``'s), the contraction to
  seeded keep-sets, ``filter_splits``/``hops_splits`` against seeded class
  lists and winter lists, ``save_edges``'s file, ``verify_reference_counts`` (strict and
  not), and ``edges_from_wordnet`` without NLTK's corpus (both raise);
- both CLIs end to end on the same files: equal outputs and report, and
  the edges' digest that the smoke run's builder phase pins;
- ``standard_splits``, ``lowshot_splits`` and ``p21k_class_split`` over a
  seeded fake file system (``tests/test_splits.py``'s lister), at several
  seeds.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from hgr_tpu.data import splits as jsplits
from hgr_tpu.hierarchy import builder as jbuilder
from hgr_tpu_torch.data import splits
from hgr_tpu_torch.hierarchy import builder

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def _inputs(seed, tmp_path):
    """``chip_smoke.py``'s seeded structure XML, its edges (JAX's), the
    sorted synsets, the class lists and the winter list."""
    path = tmp_path / f"structure_{seed}.xml"
    path.write_text(chip_smoke.structure_xml(seed))
    edges = jbuilder.edges_from_structure_xml(str(path))
    nodes = sorted({v for _, v in edges})
    testsets, winter = chip_smoke.builder_lists(seed, nodes)
    return path, edges, nodes, testsets, winter


def test_builder_matches_jax(tmp_path):
    for seed in (0, 1, 2):
        path, want_edges, nodes, testsets, winter = _inputs(seed, tmp_path)
        edges = builder.edges_from_structure_xml(str(path))
        assert edges == want_edges and len(edges) == len(set(edges))
        assert ("fall11", "n00021265") in edges and not {"misc", "junk1"} & set(nodes)
        rng = np.random.default_rng(seed)
        for k in (1, 30, len(nodes) // 2):
            keep = [nodes[i] for i in rng.choice(len(nodes), k, replace=False)]
            assert builder.contract_graph(edges, keep) == jbuilder.contract_graph(edges, keep)
        assert (builder.filter_splits(testsets, winter, nodes)
                == jbuilder.filter_splits(testsets, winter, nodes))
        assert (builder.hops_splits(testsets, winter, nodes)
                == jbuilder.hops_splits(testsets, winter, nodes))
        builder.save_edges(edges, str(tmp_path / "a.json"))
        jbuilder.save_edges(want_edges, str(tmp_path / "b.json"))
        assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()

    assert builder.REFERENCE_COUNTS == jbuilder.REFERENCE_COUNTS
    want = jbuilder.REFERENCE_COUNTS
    ok = {"train": ["x"] * want["train"], "rest": ["y"] * want["rest"]}
    hops = {k: ["z"] * want[k] for k in ("hop2", "hop3", "hop3_pure")}
    assert builder.verify_reference_counts(want["nodes"], ok, hops, n_layers=12) == []
    bad = {"train": ["x"] * 10, "rest": ["y"] * 3}
    for mod in (builder, jbuilder):
        with pytest.raises(ValueError) as err:
            mod.verify_reference_counts(5, bad, hops, n_layers=4)
        assert "train: got 10, reference pins 983" in str(err.value)
    assert (builder.verify_reference_counts(5, bad, hops, n_layers=4, strict=False)
            == jbuilder.verify_reference_counts(5, bad, hops, n_layers=4, strict=False))
    for mod in (builder, jbuilder):  # no NLTK corpus on this machine
        with pytest.raises(RuntimeError, match="NLTK WordNet corpus is not available"):
            mod.edges_from_wordnet(["n02084071"])


def test_builder_cli_matches_jax(tmp_path):
    """Both CLIs on ``chip_smoke.py``'s builder inputs: equal files and
    report, and the edges' digest is the one the smoke run pins."""
    import hashlib

    args = chip_smoke.write_builder_inputs(str(tmp_path))
    out = args.index("--out") + 1
    reports = {}
    for name, mod in (("torch", builder), ("jax", jbuilder)):
        argv = list(args)
        argv[out] = str(tmp_path / name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        reports[name] = buf.getvalue()
    assert reports["torch"] == reports["jax"] and "WARNING" in reports["torch"]
    for f in ("graph_edges_cls.json", "splits_for_tree.json", "splits_for_hops.json"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    edges = (tmp_path / "jax" / "graph_edges_cls.json").read_bytes()
    assert len(json.loads(edges)) > 40
    assert hashlib.sha256(edges).hexdigest() == chip_smoke.EXPECTED_BUILDER_SHA256


def _fs(seed):
    """A seeded fake ImageNet layout: 1k train/val folders of the seen
    classes, 21k folders of the unseen ones (some above 50 images, some
    below 10), and folders of classes in no split."""
    rng = np.random.default_rng(seed)
    seen = [f"s{i}" for i in range(6)]
    unseen = [f"u{i}" for i in range(9)]
    fs = {"1k/train": seen + ["s_extra"], "21k": unseen + ["skipme"]}
    for c in seen + ["s_extra"]:
        fs[f"1k/train/{c}"] = [f"{c}_{j}.JPEG" for j in range(int(rng.integers(1, 30)))]
        fs[f"1k/val/{c}"] = [f"{c}_v{j}.JPEG" for j in range(int(rng.integers(1, 6)))]
    for c in unseen + ["skipme"]:
        fs[f"21k/{c}"] = [f"{c}_{j}.JPEG" for j in range(int(rng.integers(3, 120)))]
    classes = {"train": seen, "rest": unseen, "all": seen + unseen}
    return fs, classes


def test_splits_match_jax():
    for fs_seed in (0, 1):
        fs, classes = _fs(fs_seed)

        def lister(path):
            return fs[path.replace("\\", "/")]

        for seed in (0, 3, 7):
            assert (splits.standard_splits("1k", "21k", classes, seed=seed, lister=lister)
                    == jsplits.standard_splits("1k", "21k", classes, seed=seed, lister=lister))
            for k_train, k_val in ((10, 50), (3, 5)):
                got = splits.lowshot_splits("1k", "21k", classes, k_train=k_train, k_val=k_val,
                                            seed=seed, lister=lister)
                assert got == jsplits.lowshot_splits("1k", "21k", classes, k_train=k_train,
                                                     k_val=k_val, seed=seed, lister=lister)
        p21k = ["s1", "u2", "u5", "zzz", "s4"]
        assert (splits.p21k_class_split(classes, p21k)
                == jsplits.p21k_class_split(classes, p21k))
