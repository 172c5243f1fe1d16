"""The port's mesh (``hgr_tpu_torch/parallel``, ``train/spmd.py``, the
driver's ``--mesh_data/--mesh_model``) against the JAX package's, on the
CPU in fp32.

The port's side runs in gloo worlds of 4 spawned processes
(``parallel.distributed.run_ranks``, the rank functions in
``tests/_torch_parallel_worker.py``), each world bounded by its own
timeout so that a hung collective fails its test. The JAX side runs on 4
of conftest's 8 virtual CPU devices.

- the sharded eval (``make_sharded_eval_step``) at meshes (2, 2), (1, 4)
  and (4, 1): every count of JAX's sharded step, at atol 1e-5, on TEST-RN
  with the JAX weights, on the FILL case (a level sunk below -1), and on
  the reference's 18,432-row geometry with a random bank, shard
  boundaries inside levels (``tests/test_eval_spmd.py:57-176``);
- one SPMD OM step at (2, 2) and (4, 1) and one CoOp ``ctx`` step
  (``make_spmd_train_step``): the loss at rtol 1e-5, the parameters at
  rtol 5e-3 / atol 3e-5 where JAX's gradient is above 1e-6
  (``tests/test_spmd.py:98-104``), every rank's bitwise equal, and the
  gradient each update applied within 1e-4 relative of the port's
  one-process gradient of the mean replica loss;
- the CLI under a world of 4: ``run_test`` at (2, 2) equals the port's
  one-process run, and one train epoch at (2, 2) equals one process
  replaying its step pairs (the mean of two replica losses a step);
- the mesh's errors, NCCL without a card, and the stop decision.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from hgr_tpu import train as jtrain  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.hierarchy import profiled_hierarchy as j_profiled  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict as j_convert_state_dict  # noqa: E402
from hgr_tpu.models.layers import l2_normalize as j_l2_normalize  # noqa: E402
from hgr_tpu.parallel.eval_spmd import make_sharded_eval_step as j_sharded_step  # noqa: E402
from hgr_tpu.parallel.mesh import MODEL as JMODEL  # noqa: E402
from hgr_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from hgr_tpu.train.spmd import make_spmd_train_step as j_spmd_step  # noqa: E402
from hgr_tpu.train.spmd import stack_schedules as j_stack_schedules  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu_torch import train  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models.clip import clip_init, get_config  # noqa: E402
from hgr_tpu_torch.parallel import distributed  # noqa: E402
from hgr_tpu_torch.parallel.distributed import run_ranks  # noqa: E402
from hgr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from hgr_tpu_torch.train.spmd import stack_schedules  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_worker as worker  # noqa: E402

WORLD = 4
TIMEOUT_S = 300.0
MESHES = ((2, 2), (1, 4), (4, 1))
# tests/test_eval_spmd.py:57: 18,278 nodes over 13 levels, padded to 18,432
REAL_PROFILE = [10, 800, 4000, 5000, 4000, 2500, 1000, 500, 250, 120, 60, 30, 8]


def _weights(arch, seed=0):
    """(JAX params, the port's state_dict as numpy) of one seeded model:
    the port's ``clip_init`` taken into the JAX layout by the JAX
    package's ``convert_state_dict`` (JAX's ``clip_init`` compiles each
    draw)."""
    sd = {k: v.numpy() for k, v in
          clip_init(get_config(arch), torch.Generator().manual_seed(seed)).state_dict().items()}
    return j_convert_state_dict(sd, jclip.get_config(arch)), sd


def _jax_sharded(jtm, params, cases, shape):
    """JAX's sharded step on 4 devices at ``shape``, one compile for every
    case: ``{case: {target: BatchMetrics as numpy}}``."""
    mesh = j_make_mesh(*shape, devices=jax.devices()[:WORLD])
    step = j_sharded_step(jtm, mesh)
    out = {}
    with mesh:
        for label, c in cases.items():
            bank_sh = jax.device_put(jnp.asarray(c["bank"]), NamedSharding(mesh, P(JMODEL, None)))
            out[label] = {t: [np.asarray(x) for x in step(params, bank_sh,
                                                           jnp.asarray(c["images"]), t,
                                                           valid=jnp.asarray(c["valid"]))]
                          for t in c["targets"]}
    return out


def _check_eval(got_ranks, want, geometry):
    for rank, got in enumerate(got_ranks):
        for shape, by_case in want.items():
            for label, by_target in by_case.items():
                for t, w in by_target.items():
                    for a, b, name in zip(got[label][shape][t], w,
                                          ("hits", "tor", "path", "point", "num")):
                        np.testing.assert_allclose(
                            a, b, atol=1e-5, err_msg=f"{geometry}/{label} {name} rank={rank} "
                                                     f"mesh={shape} target={t}")


def test_sharded_eval_matches_jax():
    """Both geometries, one after the other (see :func:`_sharded_eval_matches_jax`)."""
    for geometry in ("synthetic", "real"):
        _sharded_eval_matches_jax(geometry)


def _sharded_eval_matches_jax(geometry):
    """``synthetic``: the small hierarchy with the bank each side builds
    from the same weights, two targets, and the FILL case (level 1 sunk to
    -2 for every image: the level's prediction leaves it, a miss);
    ``real``: 18,432 rows, a random bank, a shallow, a deepest and a
    level-3 target, and the FILL case on level 5, which the (., 4) meshes'
    boundary 13,824 splits. In both, a bank of 8 distinct rows, whose ties
    fill every top-k."""
    jcfg = JConfig(arch="TEST-RN", dtype="float32")
    params, sd = _weights("TEST-RN")
    if geometry == "synthetic":
        spec, pad = ("synthetic", (3, 4, 5, 0)), 8 * WORLD
        jhier = j_synthetic(3, 4, 5, 0)
        jtm = JTreeModel.build(jcfg, jhier, pad_multiple=pad)
        jtm.params = params
        bank_s = np.asarray(jtm.sort_bank(jtm.update_classifier()), np.float32)
        targets = [0, int(jhier.level(jhier.max_depth)[0])]
        sunk = 1
    else:
        spec, pad = ("profiled", REAL_PROFILE), 1024
        jhier = j_profiled(REAL_PROFILE, seed=0, cross_edges=40)
        jtm = JTreeModel.build(jcfg, jhier, pad_multiple=pad)
        assert jtm.n_pad == 18432
        jtm.params = params
        rng = np.random.default_rng(3)
        bank = rng.standard_normal((jtm.n_pad, 64)).astype(np.float32)
        bank_s = np.asarray(jtm.sort_bank(jnp.asarray(bank / np.linalg.norm(
            bank, axis=1, keepdims=True))))
        targets = [0, int(jhier.level(jhier.max_depth)[0]), int(jhier.level(3)[17])]
        sunk = 5
    images = np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(np.float32)

    # the FILL case: identical images, so bank rows -2 x their feature give
    # every image the logit -2 on the sunk level
    img1 = np.repeat(np.random.default_rng(1).standard_normal((1, 32, 32, 3)), 8,
                     axis=0).astype(np.float32)
    feat = np.asarray(j_l2_normalize(jtm.encode_image_fn(params, jnp.asarray(img1[:1]))))[0]
    fill_bank = bank_s.copy()
    lo, hi = jtm.level_offsets[sunk], jtm.level_offsets[sunk + 1]
    if geometry == "real":
        assert lo < 13824 < hi  # the sunk level straddles a shard boundary
    fill_bank[lo:hi] = -2.0 * feat
    fill_target = int(jhier.level(sunk + 1)[0])
    assert sunk in jhier.depth[jhier.chain_with_self(fill_target)]

    # ties: the bank's rows drawn from 8 distinct ones, so that whole groups
    # of classes score alike and lax.top_k's order decides the hits
    rows = np.random.default_rng(4).integers(0, 8, jtm.n_pad)
    tie_bank = bank_s[rows]
    cases = {
        "plain": dict(bank=bank_s, images=images, valid=np.asarray([True] * 6 + [False] * 2),
                      targets=targets),
        "fill": dict(bank=fill_bank, images=img1, valid=np.ones(8, bool), targets=[fill_target]),
        "ties": dict(bank=tie_bank, images=images, valid=np.ones(8, bool),
                     targets=[int(jtm.test_index[i]) for i in (0, 5, 11)]),
    }
    want = {shape: _jax_sharded(jtm, params, cases, shape) for shape in MESHES}
    if geometry == "synthetic":  # the port builds the synthetic plain bank itself
        cases["plain"]["bank"] = None
    got = run_ranks(worker.sharded_eval_rank, WORLD, (spec, pad, sd, cases, MESHES),
                    timeout_s=TIMEOUT_S)
    _check_eval(got, want, geometry)


def _spmd_case(variant, shape):
    """Inputs of one SPMD step at mesh ``shape`` (R = data replicas, one
    deepest-level class each), JAX's and the port's."""
    data, _ = shape
    arch = "TEST-RN" if variant == "OM" else "TEST-ViT"  # CoOp as tests/test_torch_coop.py
    over = dict(arch=arch, dtype="float32", num_compare=4, lr=1e-3, w_lr=1e-3, remat=False,
                coop=variant == "coop", coop_train="ctx", grad_clip=0.5)
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    params, sd = _weights(arch)
    deep = hier.level(hier.max_depth)
    targets = [int(deep[(3 * i) % len(deep)]) for i in range(data)]
    scheds = []
    for mod, h in ((train, hier), (jtrain, jhier)):
        sampler = mod.NegativeSampler(h, np.arange(h.num_nodes), 4, seed=0,
                                      topk_window="both" if variant == "coop" else "below")
        builder = mod.ScheduleBuilder(h, sampler, 0.25, 0.5, 4)
        scheds.append([builder.build(t) for t in targets])
    images = np.random.default_rng(0).standard_normal((data, 4, 32, 32, 3)).astype(np.float32)
    return over, hier, jhier, params, sd, scheds, images


def _jax_spmd(over, jhier, params, jscheds, images, shape):
    jcfg = JConfig(**over)
    jtm = JTreeModel.build(jcfg, jhier, pad_multiple=64)
    jtm.params = params
    mesh = j_make_mesh(*shape, devices=jax.devices()[:WORLD])
    text_fn = extra_params = extra_labels = None
    frozen = ()
    if jcfg.coop:
        jstatic, jctx = jtm.coop_setup(0)
        text_fn = jtm.coop_text_fn(jstatic)
        extra_params, extra_labels, frozen = {"coop_ctx": jctx}, {"clip": "frozen",
                                                                  "coop_ctx": "clip"}, ("clip",)
    tx = jtrain.make_optimizer(jcfg, 10, extra_labels=extra_labels)
    state = jtrain.init_train_state(jtm.params, jtm.layer_weight, tx, extra_params=extra_params)
    with mesh:
        step = j_spmd_step(jcfg, jtm.clip_cfg, tx, mesh, dtype=jnp.float32, donate=False,
                           text_fn=text_fn, frozen=frozen)
        stacked = {k: jnp.asarray(v) for k, v in j_stack_schedules(jscheds).items()}
        new, loss = step(state, jnp.asarray(images), jnp.asarray(jtm.node_tokens), stacked)
    return float(loss), new, (None if extra_params is None else np.asarray(jctx))


def _mean_loss_grads(over, hier, sd, scheds, images, ctx):
    """The port's one-process gradient of the mean replica loss: the mask
    of the parameter comparison (AdamW's first step is about lr * sign(g),
    so a gradient at rounding level may flip its sign)."""
    cfg = Config(**over)
    tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    text_fn, params = None, {"clip": tm.model, "layer_weight": tm.layer_weight}
    if cfg.coop:
        static, _ = tm.coop_setup(0)
        text_fn = tm.coop_text_fn(static)
        params["coop_ctx"] = torch.tensor(ctx)
    params = train.freeze_params(params, ("clip",) if cfg.coop else ())
    loss_fn = train.make_om_loss_fn(torch.float32, "OM", cfg.weights, cfg.weighting,
                                    text_fn=text_fn)
    tokens = torch.as_tensor(tm.node_tokens).long()
    torch.stack([loss_fn(params, torch.from_numpy(images[r]), tokens,
                         train.sched_to_device(s, "cpu"))
                 for r, s in enumerate(scheds)]).mean().backward()
    grads = {k: (np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy())
             for k, v in tm.model.state_dict(keep_vars=True).items()}
    grads["layer_weight"] = tm.layer_weight.grad.numpy()
    if cfg.coop:
        grads["coop_ctx"] = params["coop_ctx"].grad.numpy()
    return grads


def test_spmd_step_matches_jax():
    """Both variants, one after the other (see :func:`_spmd_step_matches_jax`)."""
    for variant in ("OM", "coop"):
        _spmd_step_matches_jax(variant)


def _spmd_step_matches_jax(variant):
    """One step at (2, 2) and (4, 1): OM on TEST-RN over every CLIP tensor
    and ``layer_weight``; CoOp ``ctx`` on TEST-ViT, the context trained and
    CLIP frozen (bitwise unchanged)."""
    from hgr_tpu_torch.models.convert import from_jax_params

    cases, checks = [], []
    for shape in ((2, 2), (4, 1)):
        over, hier, jhier, params, sd, (scheds, jscheds), images = _spmd_case(variant, shape)
        jloss, jnew, jctx = _jax_spmd(over, jhier, params, jscheds, images, shape)
        want = {k: v.numpy() for k, v in from_jax_params(
            jax.tree.map(np.asarray, jnew.params["clip"]), get_config(over["arch"])).items()}
        want["layer_weight"] = np.asarray(jnew.params["layer_weight"])
        if jctx is not None:
            want["coop_ctx"] = np.asarray(jnew.params["coop_ctx"])
        cases.append(dict(config=over, hier=("synthetic", (3, 4, 5, 0)), weights=sd, mesh=shape,
                          images=images, sched=stack_schedules(scheds), coop_ctx=jctx))
        checks.append((shape, jloss, want, _mean_loss_grads(over, hier, sd, scheds, images,
                                                            jctx), sd, jctx))
    got = run_ranks(worker.spmd_step_rank, WORLD, (cases,), timeout_s=TIMEOUT_S)
    for i, (shape, jloss, want, grads, sd, jctx) in enumerate(checks):
        g_max = max(np.abs(g).max() for g in grads.values())
        for rank, by_case in enumerate(got):
            loss, new, step, applied = by_case[i]
            assert step == 1
            assert loss == pytest.approx(jloss, rel=1e-5), (shape, rank)
            for k, g in grads.items():
                m = np.abs(g) > 1e-6
                np.testing.assert_allclose(new[k][m], want[k][m], rtol=5e-3, atol=3e-5,
                                           err_msg=f"{k} mesh={shape} rank={rank}")
                # the gradient the update applied is the mean replica loss's
                # (AdamW's first step hides its scale)
                np.testing.assert_allclose(applied.get(k, np.zeros_like(g)), g, rtol=1e-4,
                                           atol=1e-6 * g_max,
                                           err_msg=f"gradient {k} mesh={shape} rank={rank}")
            for k, v in new.items():  # every rank ends with the same parameters
                assert np.array_equal(v, got[0][i][1][k]), (k, shape, rank)
        if variant == "coop":
            assert all(np.array_equal(new[k], sd[k]) for k in sd), "CLIP moved under ctx"
            assert not np.array_equal(new["coop_ctx"], jctx), "ctx did not move"


def test_mesh_cli_matches_one_process(tmp_path, monkeypatch):
    """``driver.main`` in a gloo world of 4 at mesh (2, 2). ``run_test``:
    the test batch of 7 rounds up to 8 (a row of padding a batch, split
    over data) and every count equals the one-process run over batches of
    7. One train epoch of 3 episodes: rounded up to 4 batches, 2 steps of
    2 replicas; the losses rank 0 logs equal one process replaying those
    step pairs at rtol 1e-5, every rank's parameters within 5e-3 relative
    + 3e-5 where the replay's gradient is above 1e-6 at both steps, and
    rank 0 alone wrote the log and ``clip_0``."""
    import json

    monkeypatch.chdir(tmp_path)  # {weights}.txt lands here
    # the synthetic images are keyed by hash(class name): the mesh's ranks
    # take rank 0's, and the one-process runs, in processes of their own,
    # the same hash seed
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    common = ["--synthetic", "True", "--arch", "TEST-RN", "--dtype", "float32",
              "--num_workers", "1"]
    mesh = ["--mesh_data", "2", "--mesh_model", "2", "--dist_backend", "gloo"]
    test = common + ["--train", "False", "--test_batch_size", "7"]
    want, = run_ranks(worker.cli_rank, 1, (test + ["--folder", str(tmp_path / "one")],),
                      timeout_s=TIMEOUT_S)
    got = run_ranks(worker.cli_rank, WORLD, (test + mesh + ["--folder", str(tmp_path / "m")],),
                    timeout_s=TIMEOUT_S)
    for summary in got:
        for k in want:
            if k in ("path_ratio", "point_ratio"):
                assert summary[k] == pytest.approx(want[k], rel=1e-6), k
            elif k != "imgs_per_sec":
                assert summary[k] == want[k], k

    fit = common + ["--train", "True", "--epochs", "1", "--n_episodes", "3", "--batch_size", "4",
                    "--num_compare", "6", "--lr", "1e-3", "--w_lr", "1e-3", "--remat", "False",
                    "--print_freq", "1", "--folder", str(tmp_path / "fit")]
    (losses, params, mask), = run_ranks(worker.replay_train_rank, 1, (fit, 2),
                                        timeout_s=TIMEOUT_S)
    got = run_ranks(worker.cli_rank, WORLD, (fit + mesh,), timeout_s=TIMEOUT_S)
    save = Config.from_args(fit).save_path
    logged = [r["loss"] for r in map(json.loads, open(os.path.join(save, "metrics.jsonl")))
              if r["event"] == "train"]
    assert len(losses) == 2 and logged == pytest.approx(losses, rel=1e-5)
    assert sorted(os.listdir(save)) == ["arguments.log", "clip_0", "clip_0.meta.json",
                                        "metrics.jsonl"]
    for rank, p in enumerate(got):
        for k, m in mask.items():
            np.testing.assert_allclose(p[k][m], params[k][m], rtol=5e-3, atol=3e-5,
                                       err_msg=f"{k} rank={rank}")
            assert np.array_equal(p[k], got[0][k]), (k, rank)


def test_mesh_errors_and_stop():
    """``make_mesh`` raises JAX's errors; NCCL without a card and an unknown
    backend raise before any connection; the mesh's pieces need divisible
    sizes; a stop asked on one rank is taken by all, and each rank's slice
    of a batch of 8 is its contiguous quarter."""
    with pytest.raises(ValueError, match="model axis 3 must divide device count 4"):
        make_mesh(model=3, world_size=4)
    with pytest.raises(ValueError, match="model axis 0 must divide device count 4"):
        make_mesh(model=0, world_size=4)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 4 devices"):
        make_mesh(data=3, model=2, world_size=4)
    m = make_mesh(world_size=4, model=2)
    assert (m.data, m.model, m.data_index, m.model_index) == (2, 2, 0, 0)
    one = make_mesh()
    assert (one.data, one.model, one.data_group, one.model_group) == (1, 1, None, None)
    with pytest.raises(ValueError, match="do not divide over model axis 2"):
        m.bank_shard(torch.zeros(5, 3))
    with pytest.raises(ValueError, match="does not divide over data axis 2"):
        m.batch_shard(np.zeros(3))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="nccl needs CUDA"):
        distributed.init_distributed("localhost:1", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="dist_backend 'mpi'"):
        distributed.init_distributed("localhost:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="dist_backend"):
        Config(dist_backend="mpi")
    assert distributed.init_distributed() == (0, 1) and not distributed.initialised()
    assert run_ranks(worker.stop_rank, WORLD, (2,), timeout_s=TIMEOUT_S) == [
        (True, False, slice(2 * r, 2 * r + 2)) for r in range(WORLD)]
