"""The port's CoOp variant against the JAX package's, on the CPU in fp32.

- ``build_coop_static`` in its three placements, and ``TreeModel.
  coop_setup``'s layout: equal arrays;
- ``coop_encode_text`` and the CoOp bank (``build_bank_ids``) on TEST-RN and
  TEST-ViT, with the same seeded weights on both sides (the port's
  ``clip_init``, taken to JAX by its ``convert_state_dict``) and the JAX
  context: within the model tests' 1e-5 of the largest feature;
- one CoOp OM train step under ``coop_train`` "ctx" and "both": the loss
  within 1e-5 relative, the context and the CLIP weights within 5e-3
  relative + 3e-5 where the port's gradient is above 1e-6 (AdamW's first
  step is about lr * sign(g)); under "ctx" the CLIP weights stay bitwise;
- ``run_test --coop`` on synthetic TEST-RN with the same weights and
  context: the JAX ``summarize`` dict, counts exactly;
- a ``clip_0`` written by ``run_train --coop`` gives its context back
  through ``--load``.
"""

import glob

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu import train as jtrain  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.eval.bank import build_bank_ids as j_build_bank_ids  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models import coop as jcoop  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict as j_convert_state_dict  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from hgr_tpu_torch import driver, train  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.eval.bank import build_bank_ids  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models import coop  # noqa: E402
from hgr_tpu_torch.models.clip import CLIP, clip_init, get_config  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.models.layers import attention_scores  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402
from hgr_tpu_torch.utils.checkpoint import restore_params  # noqa: E402
from hgr_tpu_torch.utils.logging import RunLogger  # noqa: E402

T = torch.from_numpy
REL = 1e-5  # of the largest JAX feature (tests/test_torch_models.py)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(arch, seed=0):
    """(JAX params, the port's state_dict) of one seeded model: the port's
    ``clip_init`` taken into the JAX layout by the JAX package's own
    ``convert_state_dict`` (JAX's ``clip_init`` compiles each draw)."""
    sd = clip_init(get_config(arch), torch.Generator().manual_seed(seed)).state_dict()
    params = j_convert_state_dict({k: v.numpy() for k, v in sd.items()}, jclip.get_config(arch))
    return params, sd


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _names(rng, n, vocab=400):
    return [list(map(int, rng.integers(1, vocab, size=int(rng.integers(1, 26)))))
            for _ in range(n)]


def test_coop_static_and_bank_match_jax():
    """The layouts, the prompt learner's features and the CoOp bank."""
    rng = np.random.default_rng(0)
    names = _names(rng, 9)  # some longer than the room left by 16 context slots
    for arch in ("TEST-RN", "TEST-ViT"):
        jcfg = jclip.get_config(arch)
        params, sd = _weights(arch)
        m = CLIP(get_config(arch))
        m.load_state_dict(sd)
        m.eval()
        ctx = np.asarray(jcoop.coop_ctx_init(jax.random.PRNGKey(1), 16, jcfg.transformer_width))
        sot, eot = jcfg.vocab_size - 2, jcfg.vocab_size - 1
        layouts = []
        for position in coop.POSITIONS:
            want = jcoop.build_coop_static(names, jcfg.context_length, sot, eot, 16, position, 7)
            got = coop.build_coop_static(names, jcfg.context_length, sot, eot, 16, position, 7)
            np.testing.assert_array_equal(got.tokenized, want.tokenized)
            np.testing.assert_array_equal(got.ctx_map, want.ctx_map)
            assert got.tokenized.shape[1] % 16 == 0 and (got.ctx_map >= 0).sum(1).max() == 16
            layouts.append(got)
        # the three placements' prompts in one call (their lengths are equal)
        toks = np.concatenate([x.tokenized for x in layouts])
        cmap = np.concatenate([x.ctx_map for x in layouts])
        want_f = jax.jit(lambda *a: jcoop.coop_encode_text(*a, jcfg, dtype=jnp.float32))(
            params, jnp.asarray(ctx), jnp.asarray(toks), jnp.asarray(cmap))
        with torch.inference_mode():
            got_f = coop.coop_encode_text(m, T(ctx), T(toks).long(), T(cmap).long(),
                                          dtype=torch.float32)
        _close(got_f.numpy(), want_f)

        # the bank over a TreeModel's layout: pad rows, sot and eot as in JAX
        hier, jhier = synthetic_hierarchy(3, 3, 3, 0), j_synthetic(3, 3, 3, 0)
        cfg, jcfgm = Config(arch=arch, dtype="float32"), JConfig(arch=arch, dtype="float32")
        tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
        tm.load_state_dict(sd)
        jtm = JTreeModel.build(jcfgm, jhier, pad_multiple=64)
        jtm.params = params
        static, ctx0 = tm.coop_setup(0)
        jstatic, _ = jtm.coop_setup(0)
        np.testing.assert_array_equal(static.tokenized, jstatic.tokenized)
        np.testing.assert_array_equal(static.ctx_map, jstatic.ctx_map)
        assert ctx0.shape == (16, jcfg.transformer_width)
        assert abs(float(ctx0.std()) - 0.02) < 0.005
        want_b = j_build_bank_ids({"clip": jtm.params, "coop_ctx": jnp.asarray(ctx)}, jtm.n_pad,
                                  jtm.coop_text_fn(jstatic), chunk=32, out_dtype=jnp.float32)
        got_b = build_bank_ids({"clip": tm.model, "coop_ctx": T(ctx)}, tm.n_pad,
                               tm.coop_text_fn(static), chunk=32, out_dtype=torch.float32)
        assert got_b.shape == (tm.n_pad, jcfg.embed_dim)
        _close(got_b.numpy(), want_b)


def test_coop_train_step_matches_jax():
    """One CoOp OM step on TEST-ViT (a ResNet does not train from random
    init), under coop_train "ctx" and "both", from the same weights,
    context, images and schedule."""
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    over = dict(arch="TEST-ViT", dtype="float32", num_compare=6, lr=1e-3, w_lr=1e-2, coop=True,
                grad_clip=0.5)
    jtm = JTreeModel.build(JConfig(**over), jhier, pad_multiple=64)
    jtm.params, sd = _weights("TEST-ViT")
    jstatic, jctx = jtm.coop_setup(0)
    images = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    target = int(hier.level(hier.max_depth)[3])
    for coop_train in ("ctx", "both"):
        cfg, jcfg = Config(coop_train=coop_train, **over), JConfig(coop_train=coop_train, **over)
        labels = {"ctx": {"clip": "frozen", "coop_ctx": "clip"},
                  "both": {"coop_ctx": "clip"}}[coop_train]
        frozen = ("clip",) if coop_train == "ctx" else ()
        tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
        tm.load_state_dict(sd)
        static, _ = tm.coop_setup(0)
        scheds = [mod.ScheduleBuilder(h, mod.NegativeSampler(h, tm.train_index, 6, seed=0,
                                                             topk_window="both"),
                                      c.out_ratio, c.in_ratio, 6).build(target)
                  for mod, h, c in ((train, hier, cfg), (jtrain, jhier, jcfg))]

        jtext = jtm.coop_text_fn(jstatic)
        jtx = jtrain.make_optimizer(jcfg, 10, extra_labels=labels)
        jstate = jtrain.init_train_state(jtm.params, jtm.layer_weight, jtx,
                                         extra_params={"coop_ctx": jctx})
        jstep = jtrain.make_train_step(jcfg, jtm.clip_cfg, jtx, dtype=jnp.float32, donate=False,
                                       text_fn=jtext, frozen=frozen)
        jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(jtm.node_tokens),
                              jtrain.sched_to_device(scheds[1]))

        ctx = T(np.asarray(jctx)).clone()
        text_fn = tm.coop_text_fn(static, attn_fn=attention_scores)
        args = (T(images), T(tm.node_tokens).long(), train.sched_to_device(scheds[0], "cpu"))
        # the gradient, for the mask of the comparison below
        params = train.freeze_params({"clip": tm.model, "layer_weight": tm.layer_weight,
                                      "coop_ctx": ctx}, frozen)
        train.make_om_loss_fn(torch.float32, "OM", cfg.weights, cfg.weighting,
                              text_fn=text_fn)(params, *args).backward()
        grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad.clone())
                 for k, v in [*tm.model.state_dict(keep_vars=True).items(), ("ctx", ctx)]}
        for v in [*tm.model.state_dict(keep_vars=True).values(), ctx, tm.layer_weight]:
            v.grad = None
        tx = train.make_optimizer(cfg, 10, extra_labels=labels)
        state = train.init_train_state(tm.model, tm.layer_weight, tx,
                                       extra_params={"coop_ctx": ctx})
        step = train.make_train_step(cfg, tx, dtype=torch.float32, frozen=frozen,
                                     text_fn=text_fn)
        before = {k: v.clone() for k, v in tm.model.state_dict().items()}
        state, loss = step(state, *args)

        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), coop_train
        m = grads["ctx"].abs().numpy() > 1e-6
        assert m.any()
        got_ctx = state.params["coop_ctx"].detach().numpy()
        np.testing.assert_allclose(got_ctx[m], np.asarray(jstate.params["coop_ctx"])[m],
                                   rtol=5e-3, atol=3e-5)
        assert not np.array_equal(got_ctx, np.asarray(jctx)), "ctx did not move"
        want = from_jax_params(_np(jstate.params["clip"]), tm.clip_cfg)
        for k, v in tm.model.state_dict().items():
            if frozen:
                assert torch.equal(v, before[k]), k
            mk = grads[k].abs() > 1e-6
            torch.testing.assert_close(v[mk], want[k][mk], rtol=5e-3, atol=3e-5, msg=k)
        assert frozen or not torch.equal(tm.model.logit_scale.detach(), before["logit_scale"])


def test_coop_run_test_and_load_match_jax(tmp_path, monkeypatch):
    """``run_test --coop`` gives the JAX summarize dict from the same weights
    and context; a CoOp run's ``clip_0`` holds its context, which ``--load``
    restores and the bank then uses."""
    monkeypatch.chdir(tmp_path)
    common = dict(arch="TEST-RN", synthetic=True, train=False, dtype="float32",
                  test_batch_size=8, num_workers=2, coop=True)
    jcfg = JConfig(folder=str(tmp_path / "jax"), **common)
    jhier, jsplits = jdriver.build_hierarchy(jcfg)
    # jdriver.build_model's tables, with the weights of _weights
    jtm = JTreeModel.build(jcfg, jhier, candidates_train=jsplits["all"],
                           candidates_test=jsplits["rest"], pad_multiple=128, seed=0)
    jtm.params, sd = _weights("TEST-RN")
    jtm.coop_ctx = jcoop.coop_ctx_init(jax.random.PRNGKey(5), 16, jtm.clip_cfg.transformer_width)
    want = jdriver.run_test(jcfg, jtm, jsplits, JRunLogger(jcfg.save_path, echo=False))

    cfg = Config(folder=str(tmp_path / "torch"), **common)
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device="cpu")
    assert tm.n_pad == jtm.n_pad
    tm.load_state_dict(sd)
    tm.coop_ctx = T(np.asarray(jtm.coop_ctx))
    got = driver.run_test(cfg, tm, splits, RunLogger(cfg.save_path, echo=False))
    for d in (got, want):
        d.pop("imgs_per_sec")
    assert got["num_samples"] == want["num_samples"] == 40 * 8
    for key in ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20", "tor"):
        assert got[key] == want[key], key
    for key in ("path_ratio", "point_ratio"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key

    # run_train --coop writes clip_0 with the trained context; --load gives it back
    folder = str(tmp_path / "coop_train")
    argv = ["--synthetic", "True", "--arch", "TEST-RN", "--dtype", "float32", "--coop", "True",
            "--coop_train", "ctx", "--epochs", "1", "--n_episodes", "2", "--batch_size", "4",
            "--num_compare", "6", "--lr", "1e-2", "--num_workers", "2", "--folder", folder]
    state = driver.main(argv, device="cpu")
    ctx = state.params["coop_ctx"].detach()
    saved = restore_params(glob.glob(f"{folder}/**/clip_0", recursive=True)[0])
    assert torch.equal(saved["coop_ctx"], ctx)
    loaded = driver.build_model(Config.from_args(argv + ["--load", "True", "--from_epoch", "0"]),
                                hier, splits, device="cpu")
    assert torch.equal(loaded.coop_ctx, ctx)
    assert driver.run_test(cfg, loaded, splits,
                           RunLogger(str(tmp_path / "l"), echo=False))["num_samples"] == 320
