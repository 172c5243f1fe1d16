"""Offline hierarchy construction: ImageNet XML / WordNet -> edge lists + splits
(the port's copy of ``hgr_tpu/hierarchy/builder.py``; plain Python, no
networkx).

Behavioural rebuild of the reference's offline scripts
(``data/hierarchical.py``, ``data/remove_irrelevant.py``, ``data/hops.py``)
without networkx:

- :func:`edges_from_structure_xml` — parse ImageNet's ``structure_release.xml``,
  drop the "fall11misc" subtree but re-attach the food subtree (reference
  ``data/hierarchical.py:13-15``), DFS-emit deduplicated parent->child edges.
- :func:`edges_from_wordnet` — hypernym-closure fallback when the XML is
  unavailable (the reference ships without it, ``.MISSING_LARGE_BLOBS``);
  pattern from the reference's DGP materials
  (``baseline/DGP/materials/make_induced_graph.py:30-43``). Gated on NLTK data.
- :func:`contract_graph` — contract nodes outside a keep-set, reconnecting
  each removed node's parents to its children (reference
  ``data/remove_irrelevant.py:16-33``). The reference iterates a Python set
  (order nondeterministic across runs); the final edge *set* is
  order-independent, and we use sorted order so the output — and therefore the
  downstream node ordering — is reproducible.
- :func:`filter_splits` / :func:`hops_splits` — intersect the official class
  lists with winter-2021 and the graph (reference ``data/hierarchical.py:49-87``,
  ``data/hops.py:49-85``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from .tree import ROOT

Edge = Tuple[str, str]


def edges_from_structure_xml(xml_path: str, root_name: str = ROOT) -> List[Edge]:
    """Parse ImageNet's ``structure_release.xml`` into a deduplicated edge list."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(xml_path)
    release = tree.getroot()
    fall11 = release[1]

    # Drop the trailing misc subtree but keep its food subtree, as the
    # reference does (data/hierarchical.py:13-15).
    misc = fall11[-1]
    food = misc.findall(".//synset[@wnid='n00021265']")
    fall11.remove(misc)
    if food:
        fall11.append(food[0])

    edges: List[Edge] = []
    seen: Set[Edge] = set()

    def _dfs(elem, parent_wnid: str) -> None:
        for child in elem:
            e = (parent_wnid, child.attrib["wnid"])
            if e not in seen:
                seen.add(e)
                edges.append(e)
            _dfs(child, child.attrib["wnid"])

    # The XML's top element acts as the virtual root "fall11".
    for child in fall11:
        e = (root_name, child.attrib["wnid"])
        if e not in seen:
            seen.add(e)
            edges.append(e)
        _dfs(child, child.attrib["wnid"])
    return edges


def edges_from_wordnet(wnids: Sequence[str], root_name: str = ROOT) -> List[Edge]:
    """Hypernym-closure DAG over ``wnids`` via NLTK WordNet.

    Fallback builder for when ``structure_release.xml`` is unavailable.
    Requires the NLTK ``wordnet`` corpus; raises ``RuntimeError`` otherwise.
    """
    try:
        from nltk.corpus import wordnet as wn

        wn.synsets("dog")  # force corpus load
    except (ImportError, LookupError) as e:  # no nltk, or no corpus
        raise RuntimeError(
            "NLTK WordNet corpus is not available; provide structure_release.xml "
            "or a prebuilt edge JSON instead"
        ) from e

    def synset(wnid: str):
        return wn.synset_from_pos_and_offset("n", int(wnid[1:]))

    def wnid_of(s) -> str:
        return "n{:08d}".format(s.offset())

    edges: List[Edge] = []
    seen: Set[Edge] = set()
    visited: Set[str] = set()
    stack = [synset(w) for w in wnids]
    roots: List[str] = []
    while stack:
        s = stack.pop()
        sid = wnid_of(s)
        if sid in visited:
            continue
        visited.add(sid)
        hypers = s.hypernyms() + s.instance_hypernyms()
        if not hypers:
            roots.append(sid)
        for h in hypers:
            e = (wnid_of(h), sid)
            if e not in seen:
                seen.add(e)
                edges.append(e)
            stack.append(h)
    root_edges = [(root_name, r) for r in sorted(set(roots))]
    return root_edges + edges


def contract_graph(edges: Sequence[Edge], keep: Iterable[str], root_name: str = ROOT) -> List[Edge]:
    """Contract nodes not in ``keep`` (reconnect parents <-> children).

    Equivalent to the reference's iterative node removal
    (``data/remove_irrelevant.py:16-33``); the resulting edge set equals
    "connect u->v iff there is a path u->...->v through removed nodes only".
    Deterministic: removal happens in sorted node order and surviving edges are
    emitted grouped by parent in first-seen order.
    """
    keep_set = set(keep) | {root_name}
    parents: Dict[str, List[str]] = {}
    children: Dict[str, List[str]] = {}
    order: List[str] = []
    seen_nodes: Set[str] = set()

    def _touch(n: str) -> None:
        if n not in seen_nodes:
            seen_nodes.add(n)
            order.append(n)
            parents.setdefault(n, [])
            children.setdefault(n, [])

    edge_set: Set[Edge] = set()
    for u, v in edges:
        _touch(u)
        _touch(v)
        if (u, v) not in edge_set:
            edge_set.add((u, v))
            children[u].append(v)
            parents[v].append(u)

    def _add(u: str, v: str) -> None:
        if (u, v) not in edge_set and u != v:
            edge_set.add((u, v))
            children[u].append(v)
            parents[v].append(u)

    def _del(u: str, v: str) -> None:
        if (u, v) in edge_set:
            edge_set.discard((u, v))
            children[u].remove(v)
            parents[v].remove(u)

    for rm in sorted(n for n in seen_nodes if n not in keep_set):
        ps = list(parents[rm])
        cs = list(children[rm])
        for p in ps:
            _del(p, rm)
        for c in cs:
            _del(rm, c)
        for p in ps:
            for c in cs:
                _add(p, c)
        order.remove(rm)

    out: List[Edge] = []
    for u in order:
        if u in keep_set:
            for v in children[u]:
                out.append((u, v))
    return out


def filter_splits(
    testsets: Dict[str, List[str]],
    winter_wnids: Iterable[str],
    graph_nodes: Iterable[str],
) -> Dict[str, List[str]]:
    """``splits_for_tree.json``: seen train + unseen rest + all, intersected
    with winter-2021 and the graph (reference ``data/hierarchical.py:49-87``)."""
    winter = set(winter_wnids)
    nodes = set(graph_nodes)

    def _filt(names: List[str]) -> List[str]:
        return [n for n in names if n in nodes and n in winter]

    train = _filt(testsets["train"])
    rest = _filt(testsets["all"])
    all_list: List[str] = []
    seen: Set[str] = set()
    for n in train + rest:
        if n not in seen:
            seen.add(n)
            all_list.append(n)
    return {"train": train, "rest": rest, "all": all_list}


def hops_splits(
    testsets: Dict[str, List[str]],
    winter_wnids: Iterable[str],
    graph_nodes: Iterable[str],
) -> Dict[str, List[str]]:
    """``splits_for_hops.json`` (reference ``data/hops.py:49-85``)."""
    winter = set(winter_wnids)
    nodes = set(graph_nodes)

    def _filt(names: List[str]) -> List[str]:
        return [n for n in names if n in nodes and n in winter]

    return {
        "hop2": _filt(testsets["2-hops"]),
        "hop3": _filt(testsets["3-hops"]),
        "hop3_pure": _filt(testsets["3-hops-pure"]),
    }


def save_edges(edges: Sequence[Edge], path: str) -> None:
    with open(path, "w") as f:
        json.dump([list(e) for e in edges], f)


# The exact scale the reference pipeline produces (supp Table 1; pinned in
# code comments at data/train_test_split_backup.py:86-89 and printed by
# data/hops.py:49-85). A regeneration run MUST reproduce these or the
# downstream node ordering / published-metric parity is void.
REFERENCE_COUNTS = {
    "nodes": 18278,        # classes in graph_edges_cls.json
    "train": 983,          # seen classes
    "rest": 17295,         # unseen classes (= nodes - train)
    "layers": 12,          # hierarchy depth layers (supp Table 3)
    "hop2": 1533,          # data/hops.py printed counts
    "hop3": 6986,
    "hop3_pure": 5453,
}


def verify_reference_counts(
    num_nodes: int,
    splits: Dict[str, List[str]],
    hops: Dict[str, List[str]] = None,
    n_layers: int = None,
    strict: bool = True,
) -> List[str]:
    """Self-check a regenerated hierarchy against :data:`REFERENCE_COUNTS`.

    Returns the list of mismatch descriptions (empty = parity); raises
    ``ValueError`` when ``strict`` and any mismatch exists."""
    want = REFERENCE_COUNTS
    got = {
        "nodes": num_nodes,
        "train": len(splits["train"]),
        "rest": len(splits["rest"]),
    }
    if n_layers is not None:
        got["layers"] = n_layers
    if hops is not None:
        got.update({k: len(hops[k]) for k in ("hop2", "hop3", "hop3_pure")})
    problems = [
        f"{k}: got {v}, reference pins {want[k]}"
        for k, v in got.items() if v != want[k]
    ]
    if problems and strict:
        raise ValueError(
            "regenerated hierarchy does not match the reference scale:\n  "
            + "\n  ".join(problems)
        )
    return problems


def main(argv=None) -> None:
    """Regenerate the hierarchy artifacts end-to-end and self-check counts.

    Usage::

        python -m hgr_tpu_torch.hierarchy.builder \
            --testsets imagenet-testsets.json --winter winter_2021.txt \
            [--xml structure_release.xml] --out data/process_results

    Without ``--xml`` the WordNet fallback builder is used (requires the NLTK
    corpus). Mirrors the reference's offline chain ``hierarchical.py`` ->
    ``remove_irrelevant.py`` -> ``hops.py`` (SURVEY §3.3) and asserts the
    pinned 18,278 / 983 / 17,295 scale unless ``--no-strict``.
    """
    import argparse
    import os

    from .tree import Hierarchy

    ap = argparse.ArgumentParser("hierarchy-builder")
    ap.add_argument("--testsets", required=True,
                    help="imagenet-testsets.json (official class lists)")
    ap.add_argument("--winter", required=True, help="winter_2021.txt")
    ap.add_argument("--xml", default="", help="structure_release.xml")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--no-strict", action="store_true")
    args = ap.parse_args(argv)

    with open(args.testsets) as f:
        testsets = json.load(f)
    with open(args.winter) as f:
        winter = [l.strip() for l in f if l.strip()]

    if args.xml:
        edges = edges_from_structure_xml(args.xml)
    else:
        edges = edges_from_wordnet(testsets["all"])
    full_nodes = {v for _, v in edges}
    splits = filter_splits(testsets, winter, full_nodes)
    cls_edges = contract_graph(edges, splits["all"])
    hier = Hierarchy.from_edges(cls_edges)
    hops = hops_splits(testsets, winter, set(hier.names))

    os.makedirs(args.out, exist_ok=True)
    save_edges(cls_edges, os.path.join(args.out, "graph_edges_cls.json"))
    with open(os.path.join(args.out, "splits_for_tree.json"), "w") as f:
        json.dump(splits, f)
    with open(os.path.join(args.out, "splits_for_hops.json"), "w") as f:
        json.dump(hops, f)

    problems = verify_reference_counts(
        hier.num_nodes, splits, hops, n_layers=hier.max_depth + 1,
        strict=not args.no_strict,
    )
    for p in problems:
        print(f"WARNING: {p}")
    print(
        f"hierarchy: {hier.num_nodes} nodes, {hier.max_depth + 1} layers; "
        f"splits train={len(splits['train'])} rest={len(splits['rest'])}; "
        f"hops {len(hops['hop2'])}/{len(hops['hop3'])}/{len(hops['hop3_pure'])}"
    )


if __name__ == "__main__":
    main()
