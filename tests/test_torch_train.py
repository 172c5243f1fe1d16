"""The port's OM training against the JAX package's, on the CPU in fp32.

Inputs are seeded numpy arrays and JAX ``clip_init`` weights carried over
by ``from_jax_params``; TEST-ViT is the model, since a ModifiedResNet does
not train from random init (``tests/test_convergence.py:19-29``).

- ``pair_weights`` (all six modes, and the adaptive gradient) and
  ``cosine_lr``;
- ``NegativeSampler`` and ``ScheduleBuilder``: equal array by array for all
  five strategies;
- ``om_loss`` and every gradient (OM with each weighting, hierarchical):
  loss within 1e-5 relative, gradients within 1e-5 + 1e-4 relative;
- one optimizer step against optax (plain, ``accum_steps=2``, a frozen
  group), compared where |g| > 1e-6 within 5e-3 relative + 3e-5, as
  ``__graft_entry__.py:226-244`` does (AdamW's first step is about
  lr * sign(g), so a gradient at rounding level may flip its sign);
- the ``GroupedTrainLoader`` episodes, with ``set_epoch`` and ``skip_next``;
- a mid-epoch preemption and ``--resume``, equal to an uninterrupted run;
- ``driver.run_train`` against the JAX ``run_train``: losses within 1e-4;
- the learning proof of ``tests/test_convergence.py`` on the port.

``SyntheticImageSource`` seeds by ``hash(class_name)``, which changes from
process to process, so both packages' loaders run in this process.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu import train as jtrain  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.data import GroupedTrainLoader as JLoader  # noqa: E402
from hgr_tpu.data import SyntheticImageSource as JSource  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from hgr_tpu_torch import driver  # noqa: E402
from hgr_tpu_torch import train  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.data import GroupedTrainLoader, SyntheticImageSource  # noqa: E402
from hgr_tpu_torch.eval.bank import bank_logits  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models.clip import encode_image  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402
from hgr_tpu_torch.utils import preempt  # noqa: E402
from hgr_tpu_torch.utils.checkpoint import (  # noqa: E402
    latest_epoch,
    restore_checkpoint,
    save_checkpoint,
)
from hgr_tpu_torch.utils.logging import RunLogger  # noqa: E402

T = torch.from_numpy
STRATEGIES = ("random", "simi", "topk", "near_simi", "brothers")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_pair_weights_match_jax():
    lw = np.asarray([0.3, 0.1, 0.25, 0.2, 0.15], np.float32)
    pos = np.asarray([p for L in range(1, 6) for p in range(L)], np.int32)
    length = np.asarray([L for L in range(1, 6) for _ in range(L)], np.int32)
    for mode in train.weights.MODES:
        want = np.asarray(jtrain.pair_weights(mode, jnp.asarray(pos), jnp.asarray(length),
                                              jnp.asarray(lw)))
        lw_t = T(lw.copy()).requires_grad_(True)
        got = train.pair_weights(mode, T(pos), T(length), lw_t)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7, err_msg=mode)
        if mode == "adaptive":  # layer_weight's only gradient comes from here
            coef = np.linspace(0.5, 2.0, len(pos)).astype(np.float32)
            jg = jax.grad(lambda w: jnp.sum(jtrain.pair_weights(
                mode, jnp.asarray(pos), jnp.asarray(length), w) * coef))(jnp.asarray(lw))
            (got * T(coef)).sum().backward()
            np.testing.assert_allclose(lw_t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
            assert np.abs(np.asarray(jg)).max() > 1e-3
    with pytest.raises(ValueError, match="unknown weighting"):
        train.pair_weights("bogus", T(pos), T(length), T(lw))


def test_cosine_lr_matches_jax():
    """Within float32 rounding of the base rate (the JAX schedule computes
    in float32, the port in float64; near the end 1 + cos cancels)."""
    for base, warmup, total in ((3e-7, 0, 40), (1e-3, 5, 40), (2e-3, 3, 3), (1e-4, 10, 4)):
        got = train.cosine_lr(base, warmup, total)
        want = jtrain.cosine_lr(base, warmup, total)
        for step in range(total + 2):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-6 * base), (
                base, warmup, total, step)


@pytest.fixture(scope="module")
def hiers():
    return synthetic_hierarchy(3, 4, 6, 3), j_synthetic(3, 4, 6, 3)


def test_schedules_match_jax(hiers):
    """For every strategy: every node's schedule under both methods, and the
    sampler's direct output; the similarity strategies with and without a
    feature bank (the bank is refreshed midway, as the driver does once per
    epoch)."""
    for strategy in STRATEGIES:
        _check_schedules(hiers, strategy)


def _check_schedules(hiers, strategy):
    hier, jhier = hiers
    n = hier.num_nodes
    train_ids = np.arange(0, n, 2)
    feats = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    for method in ("OM", "hierarchical"):
        for with_feats in (False, True) if "simi" in strategy else (False,):
            kw = dict(num_compare=8, k=1, seed=4, class_feats=feats if with_feats else None)
            ours = train.NegativeSampler(hier, train_ids, **kw)
            theirs = jtrain.NegativeSampler(jhier, train_ids, **kw)
            builders = [mod.ScheduleBuilder(h, s, 0.5, 0.5, 8, method=method, strategy=strategy)
                        for mod, h, s in ((train, hier, ours), (jtrain, jhier, theirs))]
            assert builders[0].p_max == builders[1].p_max
            for target in range(n):
                if with_feats and target == n // 2:
                    ours.set_class_feats(feats[::-1].copy())
                    theirs.set_class_feats(feats[::-1].copy())
                got, want = (b.build(target) for b in builders)
                for f in dataclasses.fields(want):
                    np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                                  err_msg=f"{strategy} {method} {target} {f.name}")
            parents = hier.chain_with_self(n - 1)
            assert (ours.sample(strategy, n - 1, len(parents) - 1, parents)
                    == theirs.sample(strategy, n - 1, len(parents) - 1, parents))
    assert train.max_pairs(hier, 0.25, 0.5) == jtrain.max_pairs(jhier, 0.25, 0.5)


@pytest.fixture(scope="module")
def setup():
    """TEST-ViT on both sides with the JAX weights, a deep target's
    schedule, and four images (the last zero, as a padded row)."""
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    jcfg = JConfig(arch="TEST-ViT", dtype="float32")
    jtm = JTreeModel.build(jcfg, jhier, pad_multiple=64)
    jtm.init_params(0)
    target = int(hier.level(hier.max_depth)[3])
    images = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    images[3] = 0.0
    return hier, jhier, jtm, target, images


def _port(setup, **over):
    hier, jhier, jtm, target, images = setup
    cfg = Config(arch="TEST-ViT", dtype="float32", num_compare=6, lr=1e-3, w_lr=1e-2, **over)
    tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
    tm.load_state_dict(from_jax_params(_np(jtm.params), tm.clip_cfg))
    np.testing.assert_array_equal(tm.node_tokens, jtm.node_tokens)
    jcfg = JConfig(arch="TEST-ViT", dtype="float32", num_compare=6, lr=1e-3, w_lr=1e-2, **over)
    scheds = []
    for mod, h, c in ((train, hier, cfg), (jtrain, jhier, jcfg)):
        s = mod.NegativeSampler(h, tm.train_index, 6, seed=0)
        scheds.append(mod.ScheduleBuilder(h, s, c.out_ratio, c.in_ratio, 6,
                                          method=c.training_method).build(target))
    return cfg, jcfg, tm, scheds


def _grads_close(got_sd, want_sd):
    for k, w in want_sd.items():
        torch.testing.assert_close(got_sd[k], w, rtol=1e-4, atol=1e-5, msg=k)


OM_CASES = {  # (training_method, weights, weighting)
    "OM-both": ("OM", "adaptive", "both"),
    "OM-in": ("OM", "increasing", "in"),
    "OM-out": ("OM", "nl_decreasing", "out"),
    "hierarchical": ("hierarchical", "adaptive", "both"),
}


@pytest.mark.parametrize("case", list(OM_CASES))
def test_om_loss_and_grads_match_jax(setup, case):
    method, weights, weighting = OM_CASES[case]
    _, _, jtm, _, images = setup
    cfg, _, tm, (sched, jsched) = _port(setup, training_method=method, weights=weights,
                                        weighting=weighting)
    jfn = jtrain.make_om_loss_fn(jtm.clip_cfg, jnp.float32, method, weights, weighting)
    jparams = {"clip": jtm.params, "layer_weight": jtm.layer_weight}
    jloss, jgrads = jax.value_and_grad(jfn)(jparams, jnp.asarray(images),
                                            jnp.asarray(jtm.node_tokens),
                                            jtrain.sched_to_device(jsched))
    fn = train.make_om_loss_fn(torch.float32, method, weights, weighting, remat=True)
    params = train.freeze_params({"clip": tm.model, "layer_weight": tm.layer_weight}, ())
    loss = fn(params, T(images), T(tm.node_tokens).long(), train.sched_to_device(sched, "cpu"))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    grads = {k: v.grad for k, v in tm.model.state_dict(keep_vars=True).items()}
    assert all(g is not None for g in grads.values())
    _grads_close(grads, from_jax_params(_np(jgrads["clip"]), tm.clip_cfg))
    lw_grad = tm.layer_weight.grad
    want_lw = np.array(jgrads["layer_weight"])
    if weights == "adaptive":
        assert np.abs(want_lw).max() > 1e-4
        torch.testing.assert_close(lw_grad, T(want_lw), rtol=1e-4, atol=1e-5)
    else:  # only the adaptive mode reads layer_weight
        assert lw_grad is None and not want_lw.any()


OPT_CASES = {"plain": {}, "accum2": dict(accum_steps=2), "frozen": dict(frozen=True)}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_step_matches_optax(setup, case):
    """The train step against the JAX one: AdamW after the global-norm clip
    on the CLIP tensors, SGD on layer_weight; with ``accum_steps=2`` the
    first call moves nothing; a group labelled frozen stays as it was."""
    over = dict(OPT_CASES[case])
    frozen = ("clip",) if over.pop("frozen", False) else ()
    labels = {"clip": "frozen"} if frozen else None
    _, _, jtm, _, images = setup
    cfg, jcfg, tm, (sched, jsched) = _port(setup, grad_clip=0.5, **over)
    jtx = jtrain.make_optimizer(jcfg, 10, extra_labels=labels)
    jstate = jtrain.init_train_state(jtm.params, jtm.layer_weight, jtx)
    jstep = jtrain.make_train_step(jcfg, jtm.clip_cfg, jtx, dtype=jnp.float32, donate=False,
                                   frozen=frozen)
    tx = train.make_optimizer(cfg, 10, extra_labels=labels)
    state = train.init_train_state(tm.model, tm.layer_weight, tx)
    step = train.make_train_step(cfg, tx, dtype=torch.float32, frozen=frozen)
    before = {k: v.clone() for k, v in tm.model.state_dict().items()}
    lw0 = tm.layer_weight.detach().clone()

    args = (T(images), T(tm.node_tokens).long(), train.sched_to_device(sched, "cpu"))
    jargs = (jnp.asarray(images), jnp.asarray(jtm.node_tokens), jtrain.sched_to_device(jsched))
    for i in range(cfg.accum_steps):
        if i:  # accumulating: nothing moved yet
            assert all(torch.equal(v, before[k]) for k, v in tm.model.state_dict().items())
        jstate, jloss = jstep(jstate, *jargs)
        state, loss = step(state, *args)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert state.step == cfg.accum_steps and state.opt_state.count == 1

    jgrads = jax.grad(jtrain.make_om_loss_fn(jtm.clip_cfg, jnp.float32, "OM", cfg.weights,
                                             cfg.weighting))(
        {"clip": jtm.params, "layer_weight": jtm.layer_weight}, *jargs)
    gnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(jgrads["clip"]))))
    assert gnorm > cfg.grad_clip, "the clip should act in this test"
    want = from_jax_params(_np(jstate.params["clip"]), tm.clip_cfg)
    gmask = from_jax_params(_np(jgrads["clip"]), tm.clip_cfg)
    for k, v in tm.model.state_dict().items():
        m = gmask[k].abs() > 1e-6
        torch.testing.assert_close(v[m], want[k][m], rtol=5e-3, atol=3e-5, msg=k)
        if frozen:
            assert torch.equal(v, before[k]), k
    torch.testing.assert_close(tm.layer_weight.detach(), T(np.array(jstate.params["layer_weight"])),
                               rtol=5e-3, atol=3e-5)
    assert not torch.equal(tm.layer_weight.detach(), lw0), "layer_weight did not move"
    if not frozen:
        assert not torch.equal(tm.model.logit_scale.detach(), before["logit_scale"])


def test_train_loader_matches_jax():
    grouped = {c: [f"{c}/{i}.jpg" for i in range(n)] for c, n in (("a", 5), ("b", 2), ("c", 7))}
    ids = {"a": 3, "b": 7, "c": 1}
    for serial in (True, False):
        def pair():
            kw = dict(n_episodes=5, seed=2, num_threads=2, serial_batches=serial)
            return (GroupedTrainLoader(grouped, ids, SyntheticImageSource(8), 4, **kw),
                    JLoader(grouped, ids, JSource(8), 4, **kw))

        def episodes(loader, epoch=None, skip=0):
            if epoch is not None:
                loader.set_epoch(epoch)
            if skip:
                loader.skip_next(skip)
            return list(loader)

        ours, theirs = pair()
        fresh, jfresh = pair()
        try:
            runs = [(episodes(ours), episodes(theirs)),            # epoch 0
                    (episodes(ours), episodes(theirs)),            # epoch 1, auto
                    (episodes(ours, 3), episodes(theirs, 3)),
                    (episodes(fresh, 3, skip=2), episodes(jfresh, 3, skip=2))]
        finally:
            for loader in (ours, theirs, fresh, jfresh):
                loader.close()
        assert len(runs[0][0]) == 5 and len(runs[3][0]) == 3
        for got, want in runs:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.target == w.target and g.paths == w.paths
                np.testing.assert_array_equal(g.valid, w.valid)
                np.testing.assert_array_equal(g.images, w.images)
        # a fresh loader skipping 2 episodes of epoch 3 serves that epoch's tail
        assert [b.paths for b in runs[3][0]] == [b.paths for b in runs[2][0][2:]]


def _losses(path):
    return [r["loss"] for r in map(json.loads, open(f"{path}/metrics.jsonl"))
            if r["event"] == "train"]


class _Preempt:
    """A ``GracefulShutdown`` whose SIGTERM arrives during step ``at``."""
    at = 1

    def __init__(self):
        self.requested = False

    def __enter__(self):
        _Preempt.live = self
        return self

    def __exit__(self, *exc):
        pass


def test_resume_mid_epoch_equals_uninterrupted(tmp_path, monkeypatch):
    """Preempted after 2 of 4 steps, then ``--resume``: the resumed run
    re-enters epoch 0 at step 2 and ends with the uninterrupted run's
    losses, weights and optimizer state. The sampler's random stream is not
    in the checkpoint (nor in the JAX package's), so the strategy here
    draws nothing at random: ``topk`` with more negatives than classes."""
    monkeypatch.chdir(tmp_path)
    common = dict(arch="TEST-ViT", synthetic=True, dtype="float32", batch_size=4,
                  num_compare=200, epochs=1, n_episodes=4, print_freq=1, num_workers=2,
                  lr=1e-3, synthetic_images_per_class=6)

    def run(folder, **over):
        cfg = Config(folder=str(tmp_path / folder), **common, **over)
        hier, splits = driver.build_hierarchy(cfg)
        tm = driver.build_model(cfg, hier, splits, device="cpu")
        logger = RunLogger(cfg.save_path, echo=False)
        return cfg, tm, driver.run_train(cfg, tm, splits, logger)

    _, tm_full, full = run("full")

    real_log = RunLogger.log_train

    def log_then_preempt(self, epoch, step, num_batches, loss):
        real_log(self, epoch, step, num_batches, loss)
        if step == _Preempt.at:
            _Preempt.live.requested = True

    with monkeypatch.context() as m:
        m.setattr(preempt, "GracefulShutdown", _Preempt)
        m.setattr(RunLogger, "log_train", log_then_preempt)
        cfg, _, cut = run("cut")
    meta = json.load(open(f"{cfg.save_path}/clip_0.meta.json"))
    assert meta == {"steps_done": 2, "steps_per_epoch": 4} and cut.step == 2
    cfg, tm, resumed = run("cut", resume=True)
    log = open(f"{cfg.save_path}/arguments.log").read()
    assert "re-entering epoch 0 at step 2/4" in log and "resumed full state" in log

    assert _losses(cfg.save_path) == _losses(tm_full.config.save_path)
    assert resumed.step == full.step == 4
    assert resumed.opt_state.count == full.opt_state.count == 4
    for k, v in tm_full.model.state_dict().items():
        torch.testing.assert_close(tm.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert torch.equal(tm.layer_weight, tm_full.layer_weight)
    a, b = (s.opt_state.adamw.state_dict()["state"] for s in (resumed, full))
    assert all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"]) for i in b)
    assert json.load(open(f"{cfg.save_path}/clip_0.meta.json"))["steps_done"] == 4

    # the blocking save, read back into a state made from other weights
    save_checkpoint(str(tmp_path / "sync"), 7, full)
    assert latest_epoch(str(tmp_path / "sync")) == 7
    other = TreeModel.build(tm.config, tm.hier, pad_multiple=tm.n_pad, device="cpu")
    other.init_params(1)
    back = restore_checkpoint(str(tmp_path / "sync" / "clip_7"),
                              train.init_train_state(other.model, other.layer_weight.clone(),
                                                     train.make_optimizer(tm.config, 4)))
    assert back.step == 4 and back.opt_state.count == 4
    for k, v in tm_full.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert torch.equal(back.params["layer_weight"], tm_full.layer_weight.detach())


def test_run_train_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: two epochs of OM training with the ``simi``
    strategy (the bank refreshed each epoch) and a test after each, from
    the same weights; the JAX side on one replica (``mesh_data=1``: the
    tests' 8 virtual CPU devices would take its SPMD branch)."""
    monkeypatch.chdir(tmp_path)
    common = dict(arch="TEST-ViT", synthetic=True, dtype="float32", batch_size=4,
                  num_compare=6, epochs=2, n_episodes=3, print_freq=1, num_workers=2,
                  lr=1e-3, synthetic_images_per_class=6, sample_strategy="simi",
                  test_after_train=True, max_test_batches=2, test_batch_size=8,
                  keep_checkpoints=1)
    jcfg = JConfig(folder=str(tmp_path / "jax"), mesh_data=1, **common)
    jhier, jsplits = jdriver.build_hierarchy(jcfg)
    jtm = jdriver.build_model(jcfg, jhier, jsplits)
    weights = from_jax_params(_np(jtm.params), jtm.clip_cfg)
    jdriver.run_train(jcfg, jtm, jsplits, JRunLogger(jcfg.save_path, echo=False))

    cfg = Config(folder=str(tmp_path / "torch"), **common)
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device="cpu")
    tm.load_state_dict(weights)
    state = driver.run_train(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))

    got, want = _losses(cfg.save_path), _losses(jcfg.save_path)
    assert len(got) == len(want) == 6 and all(math.isfinite(x) for x in got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state.step == 6
    evals = [[{k: v for k, v in r.items() if k not in ("ts", "imgs_per_sec")}
              for r in map(json.loads, open(f"{c.save_path}/metrics.jsonl"))
              if r["event"] == "eval" and r["tag"] == "final"] for c in (cfg, jcfg)]
    assert len(evals[0]) == 2 and evals[0] == evals[1]
    perf = [r for r in map(json.loads, open(f"{cfg.save_path}/metrics.jsonl"))
            if r["event"] == "epoch_perf"]
    assert [r["steps"] for r in perf] == [3, 3]
    # keep_checkpoints=1 pruned epoch 0's checkpoint and its sidecar
    assert sorted(n for n in os.listdir(cfg.save_path) if n.startswith("clip_")) == [
        "clip_1", "clip_1.meta.json"]
    assert json.load(open(f"{cfg.save_path}/clip_1.meta.json")) == {
        "steps_done": 3, "steps_per_epoch": 3}


def test_om_training_aligns_images_to_class_prompts():
    """``tests/test_convergence.py:50-126`` on the port, with the port's own
    init: after OM training on six leaf classes (a colour shift per class
    plus noise), each training image retrieves its class from the leaf
    bank, from near chance at init."""
    hier = synthetic_hierarchy(branching=3, levels=4, extra_edges=5, seed=0)
    cfg = Config(arch="TEST-ViT", dtype="float32", num_compare=6, batch_size=4, lr=2e-3,
                 remat=False, out_ratio=0.01, in_ratio=0.01, sample_strategy="random")
    tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
    tm.init_params(0)
    leaves = np.asarray(hier.level(hier.max_depth), np.int32)[:6]
    rng = np.random.default_rng(0)
    res = tm.clip_cfg.image_resolution
    imgs = {}
    for c in leaves:
        color = 2.0 * rng.standard_normal((1, 1, 1, 3))
        noise = 0.5 * rng.standard_normal((cfg.batch_size, res, res, 3))
        imgs[int(c)] = T((color + noise).astype(np.float32))

    def hit1():
        bank = tm.update_classifier()
        correct = 0
        with torch.inference_mode():
            for i, c in enumerate(leaves):
                logits = bank_logits(encode_image(tm.model, imgs[int(c)], dtype=tm.dtype), bank)
                correct += int((logits[:, leaves].argmax(dim=1) == i).sum())
        return correct / (len(leaves) * cfg.batch_size)

    rounds = 24
    tx = train.make_optimizer(cfg, total_steps=rounds * len(leaves))
    state = train.init_train_state(tm.model, tm.layer_weight, tx)
    step = train.make_train_step(cfg, tx, dtype=torch.float32)
    sampler = train.NegativeSampler(hier, leaves, cfg.num_compare, seed=0)
    builder = train.ScheduleBuilder(hier, sampler, cfg.out_ratio, cfg.in_ratio,
                                    cfg.num_compare, strategy=cfg.sample_strategy)
    tokens = T(tm.node_tokens).long()
    scheds = {int(c): train.sched_to_device(builder.build(int(c)), "cpu") for c in leaves}

    acc0 = hit1()
    losses = []
    for _ in range(rounds):
        for c in leaves:
            state, loss = step(state, imgs[int(c)], tokens, scheds[int(c)])
            losses.append(float(loss))
    acc1 = hit1()
    assert acc0 <= 0.5, f"init accuracy suspiciously high: {acc0}"
    assert acc1 >= 0.875, (f"hit@1 {acc0:.3f} -> {acc1:.3f}, "
                           f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0]
