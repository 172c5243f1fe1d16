"""The port's flat fine-tuning and baselines against the JAX package's, on
the CPU in fp32.

Weights go across as numpy trees (each family's ``from_jax``), and every
random draw the JAX functions make (dropout masks, z, eps, alpha, other
labels, the classifier's init and permutations) is made with the same
``jax.random`` calls and keys and handed to the port. Tolerances: forward
values within 1e-5 relative (1e-6 absolute), losses within 1e-5 relative;
one Adam step within 1e-4 relative + 1e-6, where the gradient is above
1e-6 when some is not (Adam's first step is about lr * sign(g)).

- ``FlatTrainLoader``: the JAX loader's batches for the same (seed, epoch),
  exactly; the flat loss, and ``run_train_flat`` against the JAX one (the
  clipped AdamW on the cosine schedule against optax's chain);
- CNZSL, GCN (edge lists exactly, adjacencies, the three modes with the
  JAX dropout masks) and FREE (nets, losses, the gradient penalty, both
  steps, synthesis and the softmax classifier): functions and one step;
- the loaders (``load_attrs``, ``load_protos``, ``FeatureFile``, GloVe,
  ``tr_word_vectors``, ``suppress_seen``) on small files written here, the
  runner's eval functions with one fixed scorer, and the runner itself:
  CNZSL and GCN learn the synthetic problem (their inits cannot match
  JAX's, so the check is learning, as ``tests/test_baseline_runner.py``),
  the guards exit as JAX's do, and the real-image path: ``--cnn`` (the
  frozen ResNet-50 featurizing ``--image_root``), ``--refit_backbone`` (DGP
  stage A') and ``--num_procs`` give JAX's metric counts exactly with one
  fixed GCN scorer on both sides, fp32, and JAX's own flip draws; the port's
  feature export reproduces its ``--cnn`` counts through ``--feature_file``.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu.baselines import clip_flat as jflat  # noqa: E402
from hgr_tpu.baselines import cnzsl as jcnzsl  # noqa: E402
from hgr_tpu.baselines import free as jfree  # noqa: E402
from hgr_tpu.baselines import gcn as jgcn  # noqa: E402
from hgr_tpu.baselines import features as jfeatures  # noqa: E402
from hgr_tpu.baselines import materials as jmat  # noqa: E402
from hgr_tpu.baselines import refit as jrefit  # noqa: E402
from hgr_tpu.baselines import run as jrun  # noqa: E402
from hgr_tpu.baselines.features import FeatureFile as JFeatureFile  # noqa: E402
from hgr_tpu.baselines.features import with_bias_column as j_with_bias_column  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.data import FlatTrainLoader as JFlatLoader  # noqa: E402
from hgr_tpu.data import SyntheticImageSource as JSource  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict as j_convert_state_dict  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from hgr_tpu_torch import driver  # noqa: E402
from hgr_tpu_torch.baselines import (  # noqa: E402
    clip_flat, cnzsl, features, free, gcn, materials, refit, run)
from hgr_tpu_torch.baselines.features import FeatureFile, with_bias_column  # noqa: E402
from hgr_tpu_torch.baselines.optim import Adam, grads, tree_leaves, tree_map  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.data import FileImageSource, FlatTrainLoader, SyntheticImageSource  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.models.resnet_std import resnet50_init  # noqa: E402
from hgr_tpu_torch.train import freeze_params  # noqa: E402
from hgr_tpu_torch.utils.checkpoint import load_pytree, save_pytree  # noqa: E402
from hgr_tpu_torch.utils.logging import RunLogger  # noqa: E402

T = torch.from_numpy


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _trees_close(got, want, rtol=1e-4, atol=1e-6, grads=None, path=""):
    """Leaf by leaf, by key (``jax.tree.leaves`` sorts dict keys); with
    ``grads``, only where the gradient is above 1e-6 (a gradient at rounding
    level moves Adam's first step by lr in either direction)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _trees_close(got[k], want[k], rtol, atol, None if grads is None else grads[k],
                         f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _trees_close(a, b, rtol, atol, None if grads is None else grads[i], f"{path}/{i}")
    else:
        m = np.ones(np.shape(want), bool) if grads is None else grads.abs().numpy() > 1e-6
        _close(got.detach().numpy()[m], np.asarray(want)[m], rtol, atol, msg=path)


def _grad_tree(loss, params):
    """The gradient of ``loss`` as a tree shaped like ``params``."""
    gs = iter(grads(loss, tree_leaves(params)))
    return tree_map(lambda _: next(gs), params)


def _shapes(tree):
    return tree_map(lambda a: tuple(a.shape), tree)


def _jit(fn, **static):
    return jax.jit(lambda *a: fn(*a, **static))


def test_flat_loader_loss_and_train_match_jax(tmp_path, monkeypatch):
    """The flat path: loader batches, the loss, and ``run_train_flat``."""
    grouped = {c: [f"{c}/{i}.jpg" for i in range(n)] for c, n in (("a", 5), ("b", 2), ("c", 7))}
    ids = {"a": 3, "b": 7, "c": 1}
    for drop_last in (True, False):
        ours = FlatTrainLoader(grouped, ids, SyntheticImageSource(8), 4, seed=2, num_threads=2,
                               drop_last=drop_last)
        theirs = JFlatLoader(grouped, ids, JSource(8), 4, seed=2, num_threads=2,
                             drop_last=drop_last)
        try:
            runs = []
            for epoch in (None, None, 5):  # epochs 0 and 1 by themselves, then 5
                for loader in (ours, theirs):
                    if epoch is not None:
                        loader.set_epoch(epoch)
                runs.append((list(ours), list(theirs)))
        finally:
            ours.close()
            theirs.close()
        assert len(ours) == len(theirs) == (3 if drop_last else 4)
        for got, want in runs:
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
        assert [b[1].tolist() for b in runs[0][0]] != [b[1].tolist() for b in runs[1][0]]
    assert clip_flat.step_lr(0.1)(49) == pytest.approx(float(jflat.step_lr(0.1)(49)))

    # run_train_flat: one epoch of one batch (every seen class's image),
    # the global-norm clip acting, from the same weights
    monkeypatch.chdir(tmp_path)
    common = dict(arch="TEST-ViT", synthetic=True, dtype="float32", training_method="flat",
                  synthetic_levels=3, synthetic_images_per_class=1, batch_size=16, epochs=1,
                  lr=1e-3, grad_clip=0.5, num_workers=2, print_freq=1)
    jcfg = JConfig(folder=str(tmp_path / "jax"), **common)
    jhier, jsplits = jdriver.build_hierarchy(jcfg)
    cfg = Config(folder=str(tmp_path / "torch"), **common)
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device="cpu")
    sd = {k: v.clone() for k, v in tm.model.state_dict().items()}
    jtm = JTreeModel.build(jcfg, jhier, jsplits["all"], jsplits["rest"], pad_multiple=128)
    jtm.params = j_convert_state_dict({k: v.numpy() for k, v in sd.items()}, jtm.clip_cfg)
    assert len(splits["train"]) == 26 and tm.n_pad == jtm.n_pad

    # the loss on one batch, and the gradient for the mask below
    grouped = driver._grouped_split(cfg, "train", splits["train"], splits)
    seen_ids = hier.ids(splits["train"])
    loader = JFlatLoader(grouped, {c: hier.name_to_id[c] for c in grouped}, JSource(32), 16,
                         seed=0)
    loader.set_epoch(0)
    images, labels, _ = next(iter(loader))
    loader.close()
    labels = np.asarray([list(seen_ids).index(x) for x in labels])
    params = {"clip": tm.model}
    loss = clip_flat.flat_loss(freeze_params(params, ()), T(images),
                               T(tm.node_tokens[seen_ids]).long(), T(labels), torch.float32)
    loss.backward()
    gmask = {k: v.grad.abs() > 1e-6 for k, v in tm.model.state_dict(keep_vars=True).items()}
    for v in tm.model.state_dict(keep_vars=True).values():
        v.grad = None

    jparams = jdriver.run_train_flat(jcfg, jtm, jsplits, JRunLogger(jcfg.save_path, echo=False))
    state = driver.run_train_flat(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    losses = [[r["loss"] for r in map(json.loads, open(f"{c.save_path}/metrics.jsonl"))
               if r["event"] == "train"] for c in (cfg, jcfg)]
    assert len(losses[0]) == len(losses[1]) == 1
    # the JAX step's loss is its flat loss on this batch
    assert losses[0][0] == pytest.approx(losses[1][0], rel=1e-5)
    assert float(loss.detach()) == pytest.approx(losses[1][0], rel=1e-5)
    assert state.step == 1 and state.opt_state.count == 1
    want_sd = {k: T(np.array(v)) for k, v in _state_dict(jparams["clip"], tm).items()}
    for k, v in tm.model.state_dict().items():
        torch.testing.assert_close(v[gmask[k]], want_sd[k][gmask[k]], rtol=5e-3, atol=3e-5,
                                   msg=k)
    assert not torch.equal(tm.model.logit_scale.detach(), sd["logit_scale"])
    assert torch.equal(tm.layer_weight, driver.build_model(cfg, hier, splits, "cpu").layer_weight)


def _state_dict(jparams, tm):
    return from_jax_params(jax.tree.map(np.asarray, jparams), tm.clip_cfg)


def test_cnzsl_matches_jax():
    cfg = jcnzsl.CNZSLConfig(attr_dim=8, proto_dim=12, hid_dim=16)
    pcfg = cnzsl.CNZSLConfig(attr_dim=8, proto_dim=12, hid_dim=16)
    jparams, jstate = jax.jit(lambda key: jcnzsl.cnzsl_init(key, cfg))(jax.random.PRNGKey(0))
    params, state = cnzsl.from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jstate))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((6, 12)).astype(np.float32)
    attrs = rng.standard_normal((10, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    for training in (True, False):
        want, want_st = _jit(jcnzsl.cnzsl_logits, cfg=cfg, training=training)(
            jparams, jstate, feats, attrs)
        got, got_st = cnzsl.cnzsl_logits(params, state, T(feats), T(attrs), pcfg, training)
        _close(got, want)
        _trees_close(got_st, want_st, 1e-5)
    x = rng.standard_normal((10, 16)).astype(np.float32)
    st = jax.tree.map(np.asarray, jstate["cs1"])
    for training in (True, False):
        want, want_st = jcnzsl._standardize(jnp.asarray(x), st, training, 0.1)
        got, got_st = cnzsl._standardize(T(x), {k: T(v) for k, v in st.items()}, training, 0.1)
        _close(got, want)
        _trees_close(got_st, want_st, 1e-5)

    # one Adam step; the running statistics move, and only in training
    jstep = jcnzsl.make_cnzsl_train_step(cfg, optax.adam(1e-2))
    jp, jst, _, jloss = jstep(jparams, jstate, optax.adam(1e-2).init(jparams), feats, attrs,
                              labels)
    g = _grad_tree(torch.nn.functional.cross_entropy(
        cnzsl.cnzsl_logits(params, state, T(feats), T(attrs), pcfg, True)[0], T(labels)), params)
    assert float(g["fc2"]["b"].abs().max()) < 1e-6  # the standardisation takes the bias out
    tx = Adam(1e-2)
    step = cnzsl.make_cnzsl_train_step(pcfg, tx)
    p, st2, _, loss = step(params, state, tx.init(params), T(feats), T(attrs), T(labels))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _trees_close(p, jp, grads=g)
    _trees_close(st2, jst, 1e-5)
    assert not torch.equal(st2["cs1"]["mean"], state["cs1"]["mean"])

    # the port's own inits: the structure and ranges of both
    for proper in (True, False):
        c = dataclasses.replace(pcfg, use_proper_init=proper)
        mine, mine_st = cnzsl.cnzsl_init(torch.Generator().manual_seed(0), c)
        ref, _ = jax.eval_shape(lambda: jcnzsl.cnzsl_init(
            jax.random.PRNGKey(0), dataclasses.replace(cfg, use_proper_init=proper)))
        assert _shapes(mine) == _shapes(ref)
        b3 = np.sqrt(3.0 / (16 * 12)) if proper else np.sqrt(1.0 / 16)
        assert float(mine["fc3"]["w"].abs().max()) <= b3 < 1.2 * float(mine["fc3"]["w"].abs().max())
        assert float(mine["fc1"]["w"].abs().max()) <= np.sqrt(1.0 / 8)
        assert torch.equal(mine_st["cs2"]["var"], torch.ones(16))


def test_gcn_matches_jax():
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    n = hier.num_nodes
    for hops in (None, 4):
        got, want = gcn.dense_edges(hier, hops), jgcn.dense_edges(jhier, hops)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    np.testing.assert_array_equal(gcn.basic_edges(hier), jgcn.basic_edges(jhier))
    assert gcn.parse_hidden_layers("d16,8,d") == jgcn.parse_hidden_layers("d16,8,d")
    groups = gcn.dense_edges(hier, 4)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    target = rng.standard_normal((n, 12)).astype(np.float32)
    seen = np.sort(rng.choice(n, n // 2, replace=False)).astype(np.int64)
    for mode, edges in (("basic", [gcn.basic_edges(hier)]), ("dense", groups[:1]),
                        ("dense_att", groups)):
        adj = [gcn.Adjacency.build(e, n) for e in edges]
        radj = [gcn.Adjacency.build(e, n, transpose=True) for e in edges]
        jadj = [jgcn.Adjacency.build(e, n) for e in edges]
        jradj = [jgcn.Adjacency.build(e, n, transpose=True) for e in edges]
        for a, b in zip(adj + radj, jadj + jradj):
            for f in ("src", "dst", "wgt"):
                np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
        _close(adj[0].matvec(T(target)), jax.jit(jadj[0].matvec)(target))
        cfg = jgcn.GCNConfig(n=n, in_channels=8, out_channels=12, hidden_layers="d16,d",
                             mode=mode, n_hops=len(edges))
        pcfg = gcn.GCNConfig(**dataclasses.asdict(cfg))
        jparams = jax.jit(lambda key: jgcn.gcn_init(key, cfg))(jax.random.PRNGKey(0))
        params = gcn.from_jax(jax.tree.map(np.asarray, jparams))
        if mode == "dense_att":  # attention over hops that is not uniform
            jparams["a_att"] = jnp.asarray([0.5, 1.0, 2.0, -1.0])
            params["a_att"] = _t(jparams["a_att"]).requires_grad_(True)
        # the JAX masks: bernoulli(fold_in(key, i), keep, h.shape) (gcn.py:138-144)
        key = jax.random.PRNGKey(7)
        masks = [T(np.asarray(m)) for m in jax.jit(lambda k: [
            jax.random.bernoulli(jax.random.fold_in(k, i), 0.5, (n, c))
            for i, c in enumerate((8, 16))])(key)]
        # with the dropout masks, then in eval (no dropout), in one jit
        want_drop, want_eval = jax.jit(lambda p, xx, k: (
            jgcn.gcn_apply(p, cfg, xx, jadj, jradj, dropout_rng=k),
            jgcn.gcn_apply(p, cfg, xx, jadj, jradj)))(jparams, x, key)
        _close(gcn.gcn_apply(params, pcfg, T(x), adj, radj, masks), want_drop)
        _close(gcn.gcn_apply(params, pcfg, T(x), adj, radj), want_eval)
        want = jax.jit(jgcn.masked_l2_loss)(target[::-1], target, seen)
        _close(gcn.masked_l2_loss(T(target[::-1].copy()), T(target), T(seen)), want)

        if mode != "dense_att":  # one step, of the mode that uses every part
            continue
        tx = Adam(1e-2)
        jstep = jgcn.make_gcn_train_step(cfg, optax.adam(1e-2), jadj, jradj)
        jp, _, jloss = jstep(jparams, optax.adam(1e-2).init(jparams), x, target, seen, key)
        g = _grad_tree(gcn.masked_l2_loss(gcn.gcn_apply(params, pcfg, T(x), adj, radj, masks),
                                          T(target), T(seen)), params)
        p, _, loss = gcn.make_gcn_train_step(pcfg, tx, adj, radj)(
            params, tx.init(params), T(x), T(target), T(seen), masks)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), mode
        _trees_close(p, jp, grads=g)

    # the port's own init and masks: shapes, Xavier range, keep rate
    cfg = gcn.GCNConfig(n=n, in_channels=8, out_channels=12, hidden_layers="d16,d",
                        mode="dense_att", n_hops=4)
    mine = gcn.gcn_init(torch.Generator().manual_seed(0), cfg)
    ref = jax.eval_shape(lambda: jgcn.gcn_init(jax.random.PRNGKey(0),
                                               jgcn.GCNConfig(**dataclasses.asdict(cfg))))
    assert _shapes(mine) == _shapes(ref)
    assert float(mine["convs"][0]["w"].abs().max()) <= np.sqrt(6 / 24)
    masks = gcn.draw_dropout_masks(torch.Generator().manual_seed(0), cfg)
    assert [tuple(m.shape) for m in masks] == [(n, 8), (n, 16)]
    assert 0.4 < float(masks[1].float().mean()) < 0.6


def test_free_matches_jax():
    cfg = jfree.FREEConfig(res_size=12, att_size=6, latent_size=6, ngh=16, ndh=16,
                           nclass_seen=5, critic_iter=1, center_margin=20.0)
    pcfg = free.FREEConfig(**dataclasses.asdict(cfg))
    jparams = jax.jit(lambda key: jfree.free_init(key, cfg))(jax.random.PRNGKey(0))
    params = free.from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    B = 8
    feat = rng.random((B, 12)).astype(np.float32)
    att = rng.standard_normal((B, 6)).astype(np.float32)
    labels = rng.integers(0, 5, B)
    k = jax.random.split(jax.random.PRNGKey(3), 6)
    recon, fake = rng.random((2, B, 12)).astype(np.float32)
    mu, logvar = rng.standard_normal((2, B, 6)).astype(np.float32)
    others = jfree.other_labels(k[1], jnp.asarray(labels), 5)

    # the nets and the losses, the JAX side in one jit
    def jax_side(p, feat, att, recon, fake, mu, logvar, labels, others, k):
        return (*jfree.encoder(p["E"], feat, att), jfree.generator(p["G"], att, att),
                jfree.discriminator(p["D"], feat, att),
                *jfree.fr_forward(p["FR"], feat, k[0], 6, False),
                *jfree.fr_forward(p["FR"], feat, k[0], 6, True),
                jfree.vae_loss(recon, feat, mu, logvar), jfree.weighted_l1(recon, feat),
                jfree.trip_center_loss(p["centers"], mu, labels, others, 20.0, 0.8),
                jfree.gradient_penalty(lambda z: jfree.discriminator(p["D"], z, att), k[2],
                                       feat, fake))

    want = jax.jit(jax_side)(jparams, feat, att, recon, fake, mu, logvar, labels, others, k)
    eps = T(np.asarray(jax.random.normal(k[0], (B, 6))))
    alpha = T(np.asarray(jax.random.uniform(k[2], (B, 1))))
    offsets = T(np.asarray(jax.random.randint(k[1], labels.shape, 0, 5)))
    got = (*free.encoder(params["E"], T(feat), T(att)), free.generator(params["G"], T(att), T(att)),
           free.discriminator(params["D"], T(feat), T(att)),
           *free.fr_forward(params["FR"], T(feat), eps, 6, False),
           *free.fr_forward(params["FR"], T(feat), eps, 6, True),
           free.vae_loss(T(recon), T(feat), T(mu), T(logvar)), free.weighted_l1(T(recon), T(feat)),
           free.trip_center_loss(params["centers"], T(mu), T(labels),
                                 free.other_labels(T(labels), 5, offsets), 20.0, 0.8),
           free.gradient_penalty(lambda z: free.discriminator(params["D"], z, T(att)), alpha,
                                 T(feat), T(fake)))
    assert len(got) == len(want) == 18
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, msg=str(i))
    np.testing.assert_array_equal(free.other_labels(T(labels), 5, offsets).numpy(), others)
    jn = jnp.asarray

    # one D step and one G step, the draws split as the JAX steps split them
    d_step, g_step, init_opts = jfree.make_free_steps(cfg)
    pd_step, pg_step, pinit = free.make_free_steps(pcfg)
    jo, po = init_opts(jparams), pinit(params)
    jout = d_step(jparams, *jo[:3], jn(feat), jn(att), jn(labels), others, jnp.asarray(10.0), k[3])
    r1, r2, r3 = jax.random.split(k[3], 3)
    draws = {"z": _t(jax.random.normal(r1, (B, 6))), "eps": _t(jax.random.normal(r2, (B, 6))),
             "alpha": _t(jax.random.uniform(r3, (B, 1)))}
    pout = pd_step(params, *po[:3], T(feat), T(att), T(labels), _t(others), 10.0, draws)
    for got, want in zip(pout[4:], jout[4:]):  # d_cost, wass, gp
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    for part in ("D", "FR", "centers"):
        _trees_close(params[part], jout[0][part])
    jp2, _, jgl = g_step(jout[0], jo[3], jn(feat), jn(att), k[4])
    g1, g2 = jax.random.split(k[4])
    _, _, gl = pg_step(params, po[3], T(feat), T(att),
                       {"z": _t(jax.random.normal(g1, (B, 6))),
                        "eps": _t(jax.random.normal(g2, (B, 6)))})
    assert float(gl) == pytest.approx(float(jgl), rel=1e-5)
    for part in ("E", "G", "D"):
        _trees_close(params[part], jp2[part])

    # synthesis over every class, then the softmax classifier
    attrs = rng.standard_normal((7, 6)).astype(np.float32)
    z = np.asarray(jax.random.normal(k[5], (7, 4, 6)))
    jsyn, jlab = jax.jit(lambda p, a, key: jfree.synthesize_features(p, cfg, a, 4, key))(
        jp2, attrs, k[5])
    syn, lab = free.synthesize_features(params, pcfg, T(attrs), 4, T(z), chunk=5)
    _close(syn, jsyn)
    np.testing.assert_array_equal(lab.numpy(), jlab)
    kc = jax.random.PRNGKey(9)
    jclf = jfree.train_softmax_classifier(kc, jsyn, jlab, 7, lr=1e-2, epochs=2, batch=12)
    k1, rest = jax.random.split(kc)
    init = {"w": _t(0.02 * jax.random.normal(jax.random.split(k1)[0], (12, 7))),
            "b": torch.zeros(7)}
    perms = []
    for _ in range(2):
        rest, pk = jax.random.split(rest)
        perms.append(_t(jax.random.permutation(pk, 28)))
    clf = free.train_softmax_classifier(syn, lab, 7, lr=1e-2, epochs=2, batch=12, init=init,
                                        perms=perms)
    _trees_close(clf, jclf)
    # the port's own init: the structure of JAX's
    mine = free.free_init(torch.Generator().manual_seed(0), pcfg)
    assert _shapes(mine) == _shapes(jparams)


def test_loaders_and_eval_match_jax(tmp_path, monkeypatch):
    """The runner's inputs, tables and eval functions on small files."""
    from hgr_tpu.eval import metrics as jmetrics

    # the JAX runner's eval calls batch_metrics eagerly: one jit instead
    monkeypatch.setattr(jmetrics, "batch_metrics",
                        jax.jit(jmetrics.batch_metrics, static_argnames=("topk",)))
    hier, jhier = synthetic_hierarchy(3, 3, 2, 0), j_synthetic(3, 3, 2, 0)
    n = hier.num_nodes
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    (tmp_path / "tf.json").write_text(json.dumps([[r.tolist()] for r in feats]))
    np.save(tmp_path / "a.npy", feats)
    words = ["red", "fox", "sea", "star", "fish"]
    (tmp_path / "glove.txt").write_text("".join(
        f"{w} {' '.join(str(float(v)) for v in rng.standard_normal(4))}\n" for w in words))
    names = {w: " ".join(rng.choice(["red-fox", "seafish", "star", "xyz", "Sea_star"], 2))
             for w in hier.names[:-3]}
    (tmp_path / "names.json").write_text(json.dumps(names))
    for path in ("tf.json", "a.npy", "glove:" + str(tmp_path / "glove.txt")):
        p = path if path.startswith("glove:") else str(tmp_path / path)
        got = run.load_attrs(p, hier, str(tmp_path / "names.json"))
        np.testing.assert_allclose(got, jrun.load_attrs(p, jhier, str(tmp_path / "names.json")),
                                   rtol=1e-6, err_msg=path)
    g, jg = (m.GloVe.from_txt(str(tmp_path / "glove.txt")) for m in (materials, jmat))
    for w in ("red-fox", "seafish", "xyz", "Star"):
        a, b = g[w], jg[w]
        assert (a is None) == (b is None) and (a is None or np.allclose(a, b)), w

    fc = rng.standard_normal((n, 7)).astype(np.float32)
    (tmp_path / "fc.json").write_text(json.dumps([[w, r.tolist()] for w, r in zip(hier.names,
                                                                                  fc)]))
    np.save(tmp_path / "fc.npy", fc)
    torch.save({"fc.weight": T(fc[:, :6]), "fc.bias": T(fc[:, 6]), "conv1.weight": torch.ones(1)},
               tmp_path / "r.pth")
    for name in ("fc.json", "fc.npy", "r.pth"):
        np.testing.assert_allclose(run.load_protos(str(tmp_path / name)),
                                   jrun.load_protos(str(tmp_path / name)), rtol=1e-6)
    np.testing.assert_allclose(materials.tr_word_vectors(feats), jmat.tr_word_vectors(feats),
                               rtol=1e-6)
    table = rng.standard_normal((3, n)).astype(np.float32)
    seen = rng.random(n) < 0.5
    for s in (4, seen):
        np.testing.assert_array_equal(materials.suppress_seen(T(table), s).numpy(),
                                      jmat.suppress_seen(table, s))
    _close(materials.logits_with_bias_column(T(feats[:3, :4]), T(fc[:, :5])),
           jmat.logits_with_bias_column(feats[:3, :4], fc[:, :5]))

    rows = {w: rng.standard_normal((int(rng.integers(1, 6)), 6)).astype(np.float32)
            for w in hier.names}
    np.savez(tmp_path / "f.npz", **rows)
    ff, jff = FeatureFile(str(tmp_path / "f.npz")), JFeatureFile(str(tmp_path / "f.npz"))
    assert ff.dim == jff.dim == 6
    w0 = hier.names[3]
    np.testing.assert_array_equal(ff.take(w0, [0, 0]), jff.take(w0, [0, 0]))
    np.testing.assert_array_equal(with_bias_column(ff.rows(w0), 7), j_with_bias_column(jff.rows(w0), 7))

    # tables, the synthetic problem and the two eval functions with one scorer
    splits = driver.synthetic_splits(hier, 0)
    for a, b in zip(run.build_eval_tables(hier, splits), jrun.build_eval_tables(jhier, splits)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(run.synthetic_problem(hier, splits, 6, 4, 3),
                    jrun.synthetic_problem(jhier, splits, 6, 4, 3)):
        np.testing.assert_array_equal(a, b)
    protos = run.synthetic_problem(hier, splits, 6, 4, 3)[1]
    w = rng.standard_normal((6, n)).astype(np.float32)
    got = run.evaluate_logit_model(lambda f: T(f) @ T(w), hier, splits, protos, 0.3, 4, 2, 1)
    want = jrun.evaluate_logit_model(lambda f: f @ w, jhier, splits, protos, 0.3, 4, 2, 1)
    assert got == pytest.approx(want, rel=1e-6) and got["num_samples"] == want["num_samples"]
    w7 = rng.standard_normal((7, n)).astype(np.float32)
    grouped = {c: [] for c in splits["rest"][:5]}
    got = run.evaluate_real_images(lambda f: T(f) @ T(w7), hier, splits, grouped, 7, ff)
    want = jrun.evaluate_real_images(lambda f: f @ w7, jhier, splits, grouped, 7,
                                     feature_file=jff, batch=2)
    assert got == pytest.approx(want, rel=1e-6)
    assert got["num_samples"] == sum(len(rows[c]) for c in grouped)

    tree = {"params": {"convs": [{"w": torch.ones(2, 3)}]}, "pred": torch.arange(4.0)}
    back = load_pytree(save_pytree(str(tmp_path / "art"), tree))
    assert torch.equal(back["params"]["convs"][0]["w"], tree["params"]["convs"][0]["w"])
    assert torch.equal(back["pred"], tree["pred"])


def test_runner_learns_and_refuses(tmp_path, monkeypatch):
    """CNZSL and GCN learn the synthetic problem (120 classes, 40 unseen:
    chance hit@1 is 2.5%); FREE gives every metric; every SystemExit guard
    that comes before training says what JAX's says; then the real-image
    path against JAX (``_real_image_runs_match_jax``)."""
    s = run.main(["--baseline", "cnzsl", "--steps", "100", "--eval_batch", "4",
                  "--save_path", str(tmp_path / "cnzsl")], device="cpu")
    assert s["hit@1"] > 25.0 and s["num_samples"] == 160
    art = load_pytree(str(tmp_path / "cnzsl"))
    assert set(art) == {"params", "state"} and art["state"]["cs1"]["var"].shape == (128,)
    s = run.main(["--baseline", "gcn", "--variant", "basic", "--steps", "120",
                  "--eval_batch", "4"], device="cpu")
    assert s["hit@1"] > 5.0
    s = run.main(["--baseline", "free", "--steps", "4", "--eval_batch", "4", "--syn_num", "8",
                  "--consider_trains", "False"], device="cpu")
    assert all(np.isfinite(s[k]) for k in ("hit@1", "tor", "path_ratio", "point_ratio"))

    hier = synthetic_hierarchy(3, 4, 5, 0)
    rng = np.random.default_rng(0)
    perm = rng.permutation(hier.num_nodes)
    seen = [hier.names[i] for i in sorted(perm[: hier.num_nodes * 2 // 3])]
    rest = [hier.names[i] for i in sorted(perm[hier.num_nodes * 2 // 3:])]
    (tmp_path / "test.json").write_text(json.dumps({rest[0]: ["a.jpg"]}))
    (tmp_path / "other.json").write_text(json.dumps({seen[0]: ["a.jpg"]}))
    (tmp_path / "train.json").write_text(json.dumps({seen[0]: ["a.jpg"]}))
    man, other, tr = (str(tmp_path / f) for f in ("test.json", "other.json", "train.json"))
    for argv in (
        ["--baseline", "cnzsl", "--refit_backbone"],
        ["--baseline", "gcn", "--train_feature_file", "x.npz"],
        ["--baseline", "cnzsl", "--train_feature_file", "x.npz"],
        ["--baseline", "gcn", "--refit_backbone"],
        ["--baseline", "gcn", "--refit_backbone", "--cnn", "c.pt", "--image_root", "r",
         "--train_manifest", tr, "--feature_file", "f.npz"],
        ["--baseline", "gcn", "--refit_backbone", "--cnn", "c.pt", "--image_root", "r",
         "--train_manifest", tr, "--refit_steps", "0"],
        ["--baseline", "gcn", "--refit_backbone", "--cnn", "c.pt", "--image_root", "r",
         "--train_manifest", man],
        ["--baseline", "cnzsl", "--image_root", "r"],
        ["--baseline", "cnzsl", "--image_root", "r", "--manifest", man],
        ["--baseline", "cnzsl", "--feature_file", "f.npz", "--manifest", other],
        ["--baseline", "clip_flat", "--image_root", "r"],
        ["--baseline", "clip_flat", "--feature_file", "f.npz"],
    ):
        with pytest.raises(SystemExit) as want:
            jrun.main(argv)
        with pytest.raises(SystemExit) as got:
            run.main(argv, device="cpu")
        assert str(got.value) == str(want.value), argv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--baseline", "cnzsl"])
    _real_image_runs_match_jax(tmp_path, monkeypatch, hier, seen, rest)


def _real_image_runs_match_jax(tmp_path, monkeypatch, hier, seen, rest):
    """``--cnn`` over seeded JPEGs of 6 test classes, and ``--cnn
    --refit_backbone`` over 6 seen classes' (2 steps of 4), against the JAX
    runner. Both runners score with one fixed GCN prediction (the GCNs'
    inits differ) whose test-class rows are their images' mean features, so
    that there are hits; the JAX featurizer and refit step run in fp32 as
    the port's do on the CPU, and the port's refit takes JAX's flip draws.
    The hit and TOR counts must be JAX's exactly, path and point within
    1e-6. The refit runs at lr 1e-6: the train-mode net at 56 px is chaotic
    (``tests/test_torch_resnet_std.py``), so a step at the default 1e-4 may
    already move a near-tied argmax apart; its step is held to JAX's
    there, the runner's flags, loaders and BatchNorm statistics here."""
    from PIL import Image

    rng = np.random.default_rng(5)
    root = tmp_path / "images"
    grouped = {}
    for cls in rest[:6] + seen[:6]:
        (root / cls).mkdir(parents=True)
        grouped[cls] = []
        for j in range(2):
            img = rng.integers(0, 256, (int(rng.integers(40, 80)), int(rng.integers(40, 80)), 3))
            Image.fromarray(img.astype(np.uint8)).save(root / cls / f"{j}.jpg", quality=90)
            grouped[cls].append(f"{cls}/{j}.jpg")
    (tmp_path / "test6.json").write_text(json.dumps({c: grouped[c] for c in rest[:6]}))
    (tmp_path / "seen6.json").write_text(json.dumps({c: grouped[c] for c in seen[:6]}))
    sd = resnet50_init(torch.Generator().manual_seed(0)).state_dict()
    sd["bn1.num_batches_tracked"] = torch.tensor(0)  # as torchvision's files hold them
    torch.save(sd, tmp_path / "r50.pth")

    pred = rng.standard_normal((hier.num_nodes, 2048)).astype(np.float32)
    featurize = features.make_featurizer(resnet50_init(torch.Generator().manual_seed(0)), crop=56)
    src = FileImageSource(64, image_root=str(root))
    for c in rest[:6]:
        rows = featurize(np.stack([src.load(c, grouped[c], j) for j in range(2)]))
        pred[hier.name_to_id[c]] = rows.mean(0).numpy()
    pred /= np.linalg.norm(pred, axis=1, keepdims=True)

    def fixed_gcn(pkg):
        def runner(*a, **kw):
            if pkg == "jax":
                def logit_fn(f):
                    f = jnp.asarray(f)
                    return (f / jnp.linalg.norm(f, axis=1, keepdims=True)) @ jnp.asarray(pred).T
            else:
                def logit_fn(f):
                    f = torch.as_tensor(f)
                    return (f / torch.linalg.norm(f, dim=1, keepdim=True)) @ torch.from_numpy(pred).T
            logit_fn.pred = pred
            return logit_fn
        return runner

    monkeypatch.setattr(jrun, "run_gcn", fixed_gcn("jax"))
    monkeypatch.setattr(run, "run_gcn", fixed_gcn("torch"))
    j_feat, j_step = jfeatures.make_featurizer, jrefit.make_refit_step
    monkeypatch.setattr(jfeatures, "make_featurizer",
                        lambda p, crop=224, dtype=None: j_feat(p, crop, jnp.float32))
    monkeypatch.setattr(jrefit, "make_refit_step",
                        lambda tx, crop, dtype=None, augment=True: j_step(tx, crop, jnp.float32,
                                                                          augment))
    keys = {"key": jax.random.PRNGKey(0)}  # refit_backbone's key, split once a step

    def jax_flips(g, n, device):
        keys["key"], k = jax.random.split(keys["key"])
        return torch.as_tensor(np.array(jax.random.bernoulli(k, shape=(n,))), device=device)

    monkeypatch.setattr(refit, "draw_flips", jax_flips)
    common = ["--baseline", "gcn", "--feat_dim", "2048", "--image_root", str(root),
              "--manifest", str(tmp_path / "test6.json"), "--cnn", str(tmp_path / "r50.pth"),
              "--eval_resolution", "64", "--eval_crop", "56", "--eval_batch", "4",
              "--num_threads", "2"]
    refit_flags = ["--refit_backbone", "--train_manifest", str(tmp_path / "seen6.json"),
                   "--refit_steps", "2", "--refit_batch", "4", "--refit_lr", "1e-6"]
    for flags in ([], refit_flags):
        want = jrun.main(common + flags)
        got = run.main(common + flags + ["--num_procs", "2", "--save_path",
                                         str(tmp_path / "gcn")], device="cpu")
        assert got["num_samples"] == want["num_samples"] == 12 and got["hit@1"] > 0
        for key in ("hit@1", "hit@2", "hit@5", "tor"):
            assert got[key] == want[key], (flags, key, got, want)
        for key in ("path_ratio", "point_ratio"):
            assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key
        if not flags:
            cnn = got
    art = load_pytree(str(tmp_path / "gcn_refit"))
    assert len(art["trlog"]["step_loss"]) == 2 and np.isfinite(art["trlog"]["step_loss"]).all()
    moved = [k for k, v in art["params"].items() if k in sd and not torch.equal(v, sd[k])]
    assert "conv1.weight" in moved and "layer4.2.bn3.running_var" in moved

    # the feature export tool, then --feature_file: the --cnn run's counts
    spec = importlib.util.spec_from_file_location(
        "export_torch_image_feats",
        Path(__file__).resolve().parent.parent / "tools" / "export_torch_image_feats.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ff = tool.main(["--manifest", str(tmp_path / "test6.json"), "--image_root", str(root),
                    "--cnn", str(tmp_path / "r50.pth"), "--out", str(tmp_path / "f.npz"),
                    "--resolution", "64", "--crop", "56", "--batch", "4", "--num_procs", "2"],
                   device="cpu")
    again = run.main(common[:4] + ["--manifest", str(tmp_path / "test6.json"),
                                   "--feature_file", ff], device="cpu")
    assert {k: again[k] for k in ("hit@1", "hit@2", "tor", "num_samples")} == \
        {k: cnn[k] for k in ("hit@1", "hit@2", "tor", "num_samples")}
