"""The PyTorch port's eval path against the JAX package's, on the CPU.

Covers the level argmax, the metrics (including the FILL = -1 rule and its
exact -1.0 boundary), the TreeModel tables, the grouped loader, and the
slice as a whole: the port's ``run_test`` gives the JAX ``run_test``'s
``summarize`` dict on the synthetic TEST-RN config with the same weights
(counts exact; the path/point ratios, fp32 sums of fractions, within 1e-6
relative). Entry points without ``device="cpu"`` raise on this host. An
option once refused, ``--trace_dir``, writes a Chrome trace of train steps
through ``torch.profiler`` (``utils/profiling.py``, whose ``TraceWindow``
is held to the JAX package's semantics, and whose spans record only while
a profiler runs); the other,
``--num_proc_workers`` (decode processes), is held to JAX on image files in
``tests/test_torch_realdata.py``. The mesh flags are ignored in a
one-process run, as in JAX; the mesh is ``tests/test_torch_parallel.py``'s.
"""

import json
import os

import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.data import GroupedTestLoader as JLoader  # noqa: E402
from hgr_tpu.data import SyntheticImageSource as JSource  # noqa: E402
from hgr_tpu.eval import metrics as jm  # noqa: E402
from hgr_tpu.hierarchy import profiled_hierarchy as j_profiled  # noqa: E402
from hgr_tpu.ops import bank_topk as jtopk  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from hgr_tpu.utils.logging import format_report as j_format_report  # noqa: E402
from hgr_tpu_torch import driver  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.data import GroupedTestLoader, SyntheticImageSource  # noqa: E402
from hgr_tpu_torch.device import select_device  # noqa: E402
from hgr_tpu_torch.eval import metrics as tm_  # noqa: E402
from hgr_tpu_torch.hierarchy import profiled_hierarchy, synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.ops import bank_topk as ttopk  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402
from hgr_tpu_torch.utils.logging import RunLogger, format_report  # noqa: E402

T = torch.from_numpy


def _levels_setup(N=300, n_depths=4, B=16, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, N)).astype(np.float32)
    depth = rng.integers(0, n_depths, N).astype(np.int32)
    train = rng.random(N) < 0.8
    levels = np.asarray(list(range(n_depths)) + [-1], np.int32)
    order = np.argsort(depth, kind="stable")
    offsets = [0]
    for d in range(n_depths):
        offsets.append(offsets[-1] + int((depth == d).sum()))
    return logits, depth, train, levels, order, tuple(offsets)


def test_level_argmax_matches_jax():
    """Both level argmaxes equal JAX's; with ``sink`` a whole level scores
    below FILL, so the oracle leaves the level (the fill rule); on ties the
    first index wins, as in JAX."""
    for sink in (None, 2):
        _level_argmax_matches_jax(sink)
    _level_argmax_first_index_on_ties()


def _level_argmax_matches_jax(sink):
    logits, depth, train, levels, order, offsets = _levels_setup()
    if sink is not None:
        logits[:, depth == sink] = -2.0
    want = np.asarray(jtopk.level_argmax_xla(
        jnp.asarray(logits), jnp.asarray(levels), jnp.asarray(depth), jnp.asarray(train)))
    got = ttopk.level_argmax_xla(T(logits), T(levels), T(depth), T(train)).numpy()
    np.testing.assert_array_equal(got, want)

    ws, wv = jtopk.level_argmax_sorted(
        jnp.asarray(logits[:, order]), offsets, jnp.asarray(train[order]))
    gs, gv = ttopk.level_argmax_sorted(T(logits[:, order]), offsets, T(train[order]))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if sink is not None:
        assert (depth[got[sink]] != sink).all()
        assert (gv.numpy()[sink] <= ttopk.FILL).all()


def _level_argmax_first_index_on_ties():
    logits = np.zeros((3, 10), np.float32)
    logits[:, [2, 5, 7]] = 1.0
    train = np.ones(10, bool)
    gs, _ = ttopk.level_argmax_sorted(T(logits), (0, 4, 10), T(train))
    ws, _ = jtopk.level_argmax_sorted(jnp.asarray(logits), (0, 4, 10), jnp.asarray(train))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert gs.numpy()[:, 0].tolist() == [2, 5, 2]


def _metric_case(case):
    """Logits over the tiny synthetic hierarchy, shaped to fire the rule
    named by ``case``."""
    h = synthetic_hierarchy(branching=3, levels=4, extra_edges=5, seed=0)
    N, B = h.num_nodes, 6
    rng = np.random.default_rng(7)
    logits = rng.uniform(-0.5, 0.5, (B, N)).astype(np.float32)
    depth = h.depth
    train = rng.random(N) < 0.7
    test = ~train
    target = int(np.flatnonzero(test & (depth == depth.max()))[0])
    chain = np.asarray(h.chain_with_self(target), np.int32)
    if case == "fill":        # level 1 scores below -1 everywhere
        logits[:, depth == 1] = -1.5
    elif case == "boundary":  # the chain's level-1 node scores exactly -1.0
        logits[:, depth == 1] = -3.0
        train[chain[1]] = True
        logits[:, chain[1]] = -1.0
    elif case == "hits":      # the chain wins everywhere
        train[chain] = True
        logits[:, chain] = 5.0
    valid = np.ones(B, bool)
    valid[-1] = False
    return h, logits, train, test, target, chain, valid


def test_metrics_match_jax():
    """Each case: random logits, the FILL rule, its exact -1.0 boundary, and
    a chain that wins everywhere (with the Hit@k tie order)."""
    for case in ("random", "fill", "boundary", "hits"):
        _check_metrics(case)


def _check_metrics(case):
    h, logits, train, test, target, chain, valid = _metric_case(case)
    chain_p = np.full(h.max_chain + 1, -1, np.int32)
    chain_p[: len(chain)] = chain
    clen = np.int32(len(chain))
    depth = h.depth
    # unsorted batch_metrics
    want = jm.batch_metrics(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(chain_p), jnp.asarray(clen),
        jnp.asarray(depth), jnp.asarray(train), jnp.asarray(test), valid=jnp.asarray(valid))
    got = tm_.batch_metrics(
        T(logits), target, T(chain_p).long(), torch.tensor(clen).long(), T(depth),
        T(train), T(test), valid=T(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    # depth-sorted metrics_from_preds with the fill rule
    order = np.argsort(depth, kind="stable").astype(np.int32)
    offsets = [0]
    for d in range(int(depth.max()) + 1):
        offsets.append(offsets[-1] + int((depth == d).sum()))
    train_s = train[order]
    total = int(train_s.sum())
    fill_outside = np.asarray(
        [total - int(train_s[offsets[d]:offsets[d + 1]].sum()) > 0
         for d in range(len(offsets) - 1)] + [False])
    levels = np.where(chain_p >= 0, depth[np.maximum(chain_p, 0)], 0).astype(np.int32)
    ls = logits[:, order]
    ps, pv = jtopk.level_argmax_sorted(jnp.asarray(ls), tuple(offsets), jnp.asarray(train_s))
    want_s = jm.metrics_from_preds(
        jnp.asarray(order)[ps], jnp.asarray(ls), jnp.asarray(order), jnp.asarray(target),
        jnp.asarray(chain_p), jnp.asarray(clen), jnp.asarray(levels),
        jnp.asarray(test[order]), valid=jnp.asarray(valid), lvl_vals=pv,
        fill_outside=jnp.asarray(fill_outside))
    tps, tpv = ttopk.level_argmax_sorted(T(ls), tuple(offsets), T(train_s))
    order_t = T(order).long()
    got_s = tm_.metrics_from_preds(
        order_t[tps.long()], T(ls), order_t, target, T(chain_p).long(),
        torch.tensor(clen).long(), T(levels).long(), T(test[order]), valid=T(valid),
        lvl_vals=tpv, fill_outside=T(fill_outside))
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    if case == "fill":
        assert (tpv.numpy()[1] <= ttopk.FILL).all()
    if case == "boundary":  # the strict > FILL test makes the slot a miss
        assert (tpv.numpy()[1] == -1.0).all()
        assert (order[tps.numpy()[1]] == chain[1]).all()
    if case == "hits":
        assert float(got_s.hits[0]) == float(got_s.num) == 5.0
        assert float(got_s.point) == float(got_s.path) == 5.0
        _check_hit_at_k_tie_order()
    assert tm_.summarize(got_s) == pytest.approx(jm.summarize(want_s), rel=1e-6)


TIE_RANKS = (1, 2, 5, 10, 20, 3, 1, 2)  # per image; the last image is padding


def _tie_case(seed=5, N=18432, n_depths=4):
    """Logits in which the target ties exactly with a lower test class.

    Classes ``lower`` and ``target`` share one bank row (the same prompt),
    so every image scores them equally: the logits are the scores of the
    distinct bank rows, gathered by each class's row. Image b puts the tied
    pair at places TIE_RANKS[b] and TIE_RANKS[b] + 1 of the test ranking.
    ``lower`` comes first both by global id and by depth-sorted position.
    """
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, n_depths, N).astype(np.int32)
    test = rng.random(N) < 0.5
    target = int(np.flatnonzero(test)[-1])
    lower = int(np.flatnonzero(test[:target] & (depth[:target] <= depth[target]))[0])
    row_of = np.arange(N)
    row_of[target] = lower
    scores = rng.uniform(-1.0, 1.0, (len(TIE_RANKS), N)).astype(np.float32)
    others = test.copy()
    others[[lower, target]] = False
    for b, r in enumerate(TIE_RANKS):
        s = np.sort(scores[b, others])[::-1]
        scores[b, lower] = s[0] + 0.5 if r == 1 else (s[r - 2] + s[r - 1]) / 2
    logits = scores[:, row_of]
    assert (logits[:, target] == logits[:, lower]).all()
    valid = np.ones(len(TIE_RANKS), bool)
    valid[-1] = False
    return logits, depth, test, target, valid


def _check_hit_at_k_tie_order():
    """Hit@k ranks ties with the lower column first, as lax.top_k does: on
    the flat path by global id, on the sorted path by depth-sorted position."""
    logits, depth, test, target, valid = _tie_case()
    # the target sits one place behind its twin: a hit at k when rank + 1 <= k
    want_counts = [sum(r + 1 <= k for r, ok in zip(TIE_RANKS, valid) if ok)
                   for k in tm_.TOPK]
    want = np.asarray(jm.flat_hits(jnp.asarray(logits), jnp.asarray(target),
                                   jnp.asarray(test), valid=jnp.asarray(valid)))
    got = tm_.flat_hits(T(logits), target, T(test), valid=T(valid)).numpy()
    assert want.tolist() == want_counts == [0, 2, 4, 5, 6]
    assert got.tolist() == want.tolist()

    train = ~test
    order = np.argsort(depth, kind="stable").astype(np.int32)
    offsets = tuple(np.concatenate([[0], np.cumsum(np.bincount(depth))]).tolist())
    chain_p = np.asarray([target, -1], np.int32)
    levels = np.asarray([depth[target], 0], np.int32)
    ls = logits[:, order]
    ps, pv = jtopk.level_argmax_sorted(jnp.asarray(ls), offsets, jnp.asarray(train[order]))
    want_s = jm.metrics_from_preds(
        jnp.asarray(order)[ps], jnp.asarray(ls), jnp.asarray(order), jnp.asarray(target),
        jnp.asarray(chain_p), jnp.asarray(np.int32(1)), jnp.asarray(levels),
        jnp.asarray(test[order]), valid=jnp.asarray(valid))
    tps, _ = ttopk.level_argmax_sorted(T(ls), offsets, T(train[order]))
    order_t = T(order).long()
    got_s = tm_.metrics_from_preds(
        order_t[tps.long()], T(ls), order_t, target, T(chain_p).long(),
        torch.tensor(1), T(levels).long(), T(test[order]), valid=T(valid))
    assert np.asarray(want_s.hits).tolist() == want_counts
    assert got_s.hits.tolist() == want_counts
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _profiled(mod):
    return mod([3, 12, 30, 40, 20], seed=1, cross_edges=12)


def test_hierarchy_tables_match_jax(monkeypatch):
    """The port's tables equal the JAX package's with networkx, whether or
    not networkx imports on the port's side: the port never uses it, and
    its own bidirectional search picks networkx's chains."""
    want = _profiled(j_profiled)
    for networkx in (True, False):
        if not networkx:
            monkeypatch.setitem(sys.modules, "networkx", None)
        got = _profiled(profiled_hierarchy)
        assert got.names == want.names and got.name_to_id == want.name_to_id
        for f in ("depth", "ancestors", "child_indptr", "child_indices",
                  "level_members", "level_sizes", "root_children"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_tree_model_tables_match_jax():
    cfg, jcfg = Config(arch="TEST-RN"), JConfig(arch="TEST-RN")
    hier = _profiled(profiled_hierarchy)
    splits = driver.synthetic_splits(hier, 0)
    jsplits = {k: list(v) for k, v in splits.items()}
    got = TreeModel.build(cfg, hier, splits["all"], splits["rest"], pad_multiple=64,
                          device="cpu")
    want = JTreeModel.build(jcfg, _profiled(j_profiled), jsplits["all"], jsplits["rest"],
                            pad_multiple=64)
    assert got.n_pad == want.n_pad and got.level_offsets == want.level_offsets
    for f in ("node_tokens", "node_depth", "chains", "chain_len", "train_index",
              "test_index", "train_mask", "test_mask", "depth_order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.layer_weight.numpy(), np.asarray(want.layer_weight))


def test_grouped_loader_matches_jax():
    grouped = {"a": [f"a/{i}" for i in range(5)], "b": [f"b/{i}" for i in range(2)]}
    ids = {"a": 3, "b": 7}
    ours = GroupedTestLoader(grouped, ids, SyntheticImageSource(8), 4, num_threads=2)
    theirs = JLoader(grouped, ids, JSource(8), 4, num_threads=2)
    try:
        got, want = list(ours), list(theirs)
    finally:
        ours.close()
        theirs.close()
    assert len(got) == len(want) == ours.num_batches == 3
    for g, w in zip(got, want):
        assert g.target == w.target and g.paths == w.paths
        np.testing.assert_array_equal(g.valid, w.valid)
        np.testing.assert_array_equal(g.images, w.images)


def test_run_test_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: same summarize dict as hgr_tpu.driver.run_test."""
    monkeypatch.chdir(tmp_path)  # {weights}.txt lands here
    common = dict(arch="TEST-RN", synthetic=True, train=False, dtype="float32",
                  test_batch_size=8, num_workers=2)
    jcfg = JConfig(folder=str(tmp_path / "jax"), **common)
    hier, splits = jdriver.build_hierarchy(jcfg)
    jtm = jdriver.build_model(jcfg, hier, splits)
    want = jdriver.run_test(jcfg, jtm, splits, JRunLogger(jcfg.save_path, echo=False))

    cfg = Config(folder=str(tmp_path / "torch"), **common)
    phier, psplits = driver.build_hierarchy(cfg)
    assert psplits == splits
    tm = driver.build_model(cfg, phier, psplits, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtm.params), tm.clip_cfg))
    got = driver.run_test(cfg, tm, psplits, RunLogger(cfg.save_path, echo=False))

    for d in (got, want):
        d.pop("imgs_per_sec")
    assert set(got) == set(want)
    assert got["num_samples"] == want["num_samples"] == 40 * 8
    for key in ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20", "tor"):
        assert got[key] == want[key], key
    for key in ("path_ratio", "point_ratio"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert format_report(got) == j_format_report(want)


def test_entry_points_raise_without_cuda():
    """No entry point falls back to the CPU on its own."""
    assert not torch.cuda.is_available()
    cfg = Config(arch="TEST-RN", synthetic=True, train=False)
    hier, splits = driver.build_hierarchy(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.build_model(cfg, hier, splits)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TreeModel.build(cfg, hier)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--synthetic", "True", "--arch", "TEST-RN", "--train", "False"])
    assert select_device("cpu").type == "cpu"


def test_unported_options_raise(tmp_path):
    """The options the port once refused run. ``load_backbone`` reads a JAX
    Orbax directory (refused until the reader was ported; its features are
    held to JAX in ``tests/test_torch_orbax.py``), and a directory with
    neither ``state.pt`` nor ``_METADATA`` still raises. The mesh flags,
    refused until the mesh was ported, run: in a one-process run they are
    ignored, as JAX ignores them on one device (``hgr_tpu/driver.py:179``),
    and give the run's own summary (the mesh itself is held to JAX in
    ``tests/test_torch_parallel.py``). ``--trace_dir``, refused until the
    profiler was ported, runs: two OM steps write one Chrome trace of step
    1 onwards, its window closed when the epoch ends early.
    (``--num_proc_workers``, refused until the decode processes were
    ported, is held to JAX on image files, where processes apply, in
    ``tests/test_torch_realdata.py``.)"""
    from hgr_tpu.models.resnet_std import resnet50_init
    from hgr_tpu.utils.checkpoint import save_pytree
    from hgr_tpu_torch.baselines.features import load_backbone

    params = resnet50_init(jax.random.PRNGKey(0), num_classes=10)
    save_pytree(str(tmp_path / "orbax"), {"params": params, "trlog": {"loss": [1.0]}})
    model = load_backbone(str(tmp_path / "orbax"))
    assert model.fc.weight.shape == (10, 2048)
    assert torch.equal(model.conv1.weight, torch.from_numpy(
        np.asarray(params["conv1"]["w"]).transpose(3, 2, 0, 1).copy()))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        load_backbone(str(tmp_path / "empty"))
    base = ["--synthetic", "True", "--arch", "TEST-RN", "--train", "False", "--dtype", "float32",
            "--max_test_batches", "2", "--test_batch_size", "8", "--folder", str(tmp_path / "m")]
    want = driver.main(base, device="cpu")
    for flags in (["--mesh_model", "2"], ["--mesh_data", "4"]):
        got = driver.main(base + flags, device="cpu")
        assert {k: v for k, v in got.items() if k != "imgs_per_sec"} == {
            k: v for k, v in want.items() if k != "imgs_per_sec"}, flags
    argv = ["--synthetic", "True", "--arch", "TEST-RN", "--folder", str(tmp_path),
            "--max_test_batches", "2", "--test_batch_size", "8", "--dtype", "float32"]
    trace_dir = tmp_path / "trace"
    driver.main(argv + ["--train", "True", "--epochs", "1", "--n_episodes", "2",
                        "--batch_size", "4", "--num_compare", "6", "--trace_dir", str(trace_dir)],
                device="cpu")
    traces = sorted(trace_dir.iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    names = {e.get("name", "") for e in json.load(open(traces[0]))["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_trace_window_and_step_timer(tmp_path, monkeypatch):
    """``tests/test_utils_misc.py:83-122`` on the port: a window longer than
    the epochs starts no second trace on the next epoch's step ``start``
    (the re-entry guard), ``close`` writes the still-open window's trace
    once, the trace holds the program's spans, and an empty ``log_dir``
    does nothing. Then the spans themselves
    (:func:`_check_spans_record_only_under_profiler`) and the eval path's
    (:func:`_check_head_records_its_spans`)."""
    from hgr_tpu_torch.utils.profiling import TraceWindow, annotate

    w = TraceWindow(str(tmp_path / "t1"), start=1, stop=3)
    for _ in range(2):  # 2-step epochs end before stop=3
        for i in range(2):
            w.before(i)  # the second epoch's i == 1 meets the guard
            with annotate("window-step"):
                torch.ones(4) + 1
            w.after(i)
    assert w._prof is not None and not w.paths  # the window is still open
    w.close()
    w.close()  # once only
    assert len(w.paths) == 1 and os.listdir(tmp_path / "t1") == [os.path.basename(w.paths[0])]
    names = {e.get("name") for e in json.load(open(w.paths[0]))["traceEvents"]}
    assert "window-step" in names
    w2 = TraceWindow("", start=0, stop=1)
    w2.before(0)
    w2.after(0)
    w2.close()
    assert w2._prof is None and not w2.paths
    _check_spans_record_only_under_profiler(monkeypatch)
    _check_head_records_its_spans()


def _check_spans_record_only_under_profiler(monkeypatch):
    """``annotate`` records nothing while no profiler runs. Under one it
    records each span's parent on its own thread (a second thread's spans
    start a tree of their own), each span's ``time.time_ns`` bounds hold
    the profiler's ``record_function`` event of the same name, and spans
    beyond the buffer's cap are counted, not kept."""
    import threading

    from hgr_tpu_torch.utils import profiling
    from hgr_tpu_torch.utils.profiling import (annotate, clear_spans, dropped_spans,
                                               recorded_spans)

    clear_spans()
    with annotate("off.outer"):
        with annotate("off.inner"):
            torch.ones(4) + 1
    assert recorded_spans() == []

    def worker():
        with annotate("thread.outer"):
            with annotate("thread.inner"):
                torch.ones(4) * 2

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with annotate("outer"):
            with annotate("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with annotate("inner2"):
                pass
    finally:
        prof.stop()
    assert not t.is_alive()
    with annotate("after"):
        pass
    spans = recorded_spans()
    clear_spans()
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    assert set(by) == {"outer", "inner", "thread.outer", "thread.inner", "inner2"}
    parent = {n: spans[s.parent].name if s.parent is not None else None
              for n, (_, s) in by.items()}
    assert parent == {"outer": None, "inner": "outer", "inner2": "outer",
                      "thread.outer": None, "thread.inner": "thread.outer"}
    assert by["thread.outer"][1].thread != by["outer"][1].thread
    assert by["inner"][1].thread == by["outer"][1].thread
    for _, s in by.values():
        assert s.t0_ns <= s.t1_ns and s.host_ms == pytest.approx((s.t1_ns - s.t0_ns) * 1e-6)
        assert s.device_ms is None  # no card
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in ("outer", "inner")]
    assert sorted(e.name() for e in events) == ["inner", "outer"]
    for e in events:
        s = by[e.name()][1]
        assert s.t0_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.t1_ns, e.name()

    with monkeypatch.context() as mp:
        mp.setattr(profiling, "MAX_SPANS", 2)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for name in ("a", "b", "c"):
                with annotate(name):
                    pass
    assert [s.name for s in recorded_spans()] == ["a", "b"] and dropped_spans() == 1
    clear_spans()
    assert recorded_spans() == [] and dropped_spans() == 0


def _check_head_records_its_spans():
    """Under ``torch.profiler``, ``metrics_sorted`` records ``tree.head``
    with ``head.logits``, ``head.level_argmax`` and ``head.metrics`` inside,
    in that order, and ``encode_image`` of uint8 images ``clip.encode_image``
    with ``clip.normalize`` inside; the metrics equal an untraced call's."""
    from hgr_tpu_torch.models.clip import encode_image
    from hgr_tpu_torch.utils.profiling import clear_spans, recorded_spans

    hier = synthetic_hierarchy(3, 4, 5, 0)
    tm = TreeModel.build(Config(arch="TEST-RN"), hier, pad_multiple=64, device="cpu")
    tm.init_params(0)
    bank_s = tm.sort_bank(tm.update_classifier())
    res = tm.clip_cfg.image_resolution
    images = T(np.random.default_rng(0).integers(0, 256, (4, res, res, 3), dtype=np.uint8))
    target = int(hier.level(hier.max_depth)[0])
    with torch.inference_mode():
        want = tm.metrics_sorted(bank_s, encode_image(tm.model, images, dtype=tm.dtype), target)
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            feats = encode_image(tm.model, images, dtype=tm.dtype)
        got = tm.metrics_sorted(bank_s, feats, target)
    spans = recorded_spans()
    clear_spans()
    tree = [(s.name, spans[s.parent].name if s.parent is not None else None) for s in spans]
    assert tree == [("clip.encode_image", None), ("clip.normalize", "clip.encode_image"),
                    ("tree.head", None), ("head.logits", "tree.head"),
                    ("head.level_argmax", "tree.head"), ("head.metrics", "tree.head")]
    for k, v in want._asdict().items():
        torch.testing.assert_close(getattr(got, k), v, rtol=0, atol=0, msg=k)
