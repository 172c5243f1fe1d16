"""The PyTorch port's eval path against the JAX package's, on the CPU.

Covers the level argmax, the metrics (including the FILL = -1 rule and its
exact -1.0 boundary), the TreeModel tables, the grouped loader, and the
slice as a whole: the port's ``run_test`` gives the JAX ``run_test``'s
``summarize`` dict on the synthetic TEST-RN config with the same weights
(counts exact; the path/point ratios, fp32 sums of fractions, within 1e-6
relative). Entry points without ``device="cpu"`` raise on this host. An
option once refused, ``--trace_dir``, writes a Chrome trace of train steps
through ``torch.profiler`` (``utils/profiling.py``, whose ``TraceWindow``
and ``StepTimer`` are held to the JAX package's semantics); the other,
``--num_proc_workers`` (decode processes), is held to JAX on image files in
``tests/test_torch_realdata.py``. Only ``--mesh_*`` still raises.
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
    below FILL, so the oracle leaves the level (the fill rule)."""
    for sink in (None, 2):
        _level_argmax_matches_jax(sink)


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


def test_level_argmax_first_index_on_ties():
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
    """The multi-device layout, the one option the port still refuses,
    raises before any work, named in the message, whatever the device.
    ``--trace_dir``, refused until the profiler was ported, runs: two OM
    steps write one Chrome trace of step 1 onwards, its window closed when
    the epoch ends early. (``--num_proc_workers``, refused until the decode
    processes were ported, is held to JAX on image files, where processes
    apply, in ``tests/test_torch_realdata.py``.)"""
    for flags in (["--mesh_model", "2"], ["--mesh_data", "4"]):
        argv = ["--synthetic", "True", "--arch", "TEST-RN", "--train", "False"] + flags
        with pytest.raises(driver.NotYetPorted, match="--mesh_data/--mesh_model"):
            driver.main(argv, device="cpu")
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


def test_trace_window_and_step_timer(tmp_path):
    """``tests/test_utils_misc.py:83-122`` on the port: the timer drops its
    warm-up steps; a window longer than the epochs starts no second trace on
    the next epoch's step ``start`` (the re-entry guard), ``close`` writes
    the still-open window's trace once, and an empty ``log_dir`` does
    nothing."""
    from hgr_tpu_torch.utils.profiling import StepTimer, TraceWindow, annotate, capture_trace

    t = StepTimer(warmup=1)
    for _ in range(4):
        t.start()
        with annotate("unit-test"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
        t.stop(x)
    s = t.summary(items_per_step=8)
    assert s["steps"] == 3 and s["items_per_sec"] > 0 and s["p95_ms"] >= s["p50_ms"]
    assert StepTimer().summary() == {}

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
    with capture_trace(str(tmp_path / "t2")):
        torch.ones(2) * 2
    assert len(os.listdir(tmp_path / "t2")) == 1
    with capture_trace(""):
        pass
