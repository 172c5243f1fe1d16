"""Rank functions for ``tests/test_torch_parallel.py``: each runs in one
spawned process of a gloo world on the CPU (``parallel.distributed.
run_ranks``) and imports only torch and the port, never JAX."""

from __future__ import annotations

import torch

from hgr_tpu_torch.config import Config
from hgr_tpu_torch.hierarchy import profiled_hierarchy, synthetic_hierarchy
from hgr_tpu_torch.parallel.mesh import make_mesh
from hgr_tpu_torch.tree_model import TreeModel


def _hierarchy(spec):
    kind, args = spec
    return synthetic_hierarchy(*args) if kind == "synthetic" else profiled_hierarchy(
        args, seed=0, cross_edges=40)


def _params(tm):
    """Every CLIP tensor and ``layer_weight`` as numpy, by state_dict key."""
    out = {k: v.detach().cpu().numpy().copy() for k, v in tm.model.state_dict().items()}
    out["layer_weight"] = tm.layer_weight.detach().cpu().numpy().copy()
    return out


def sharded_eval_rank(rank, spec, pad_multiple, weights, cases, meshes):
    """The port's sharded eval of each case on every mesh of ``meshes``:
    ``{case: {mesh: {target: BatchMetrics as numpy}}}``. A case's bank is
    the depth-sorted one given, or (None) the one the port builds."""
    from hgr_tpu_torch.parallel.eval_spmd import make_sharded_eval_step

    torch.set_num_threads(1)
    tm = TreeModel.build(Config(arch="TEST-RN", dtype="float32"), _hierarchy(spec),
                         pad_multiple=pad_multiple, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    steps = {shape: make_sharded_eval_step(tm, make_mesh(*shape)) for shape in meshes}
    out = {}
    for label, c in cases.items():
        bank_s = (tm.sort_bank(tm.update_classifier()) if c["bank"] is None
                  else torch.from_numpy(c["bank"]))
        images, valid = torch.from_numpy(c["images"]), torch.from_numpy(c["valid"])
        out[label] = {}
        for shape, step in steps.items():
            mesh = step.mesh
            shard = mesh.bank_shard(bank_s)
            out[label][shape] = {
                t: [x.numpy() for x in step(shard, mesh.batch_shard(images), t,
                                            mesh.batch_shard(valid))]
                for t in c["targets"]}
    return out


def spmd_step_rank(rank, cases):
    """One port SPMD step of each case, on its ``mesh``: a list of (loss,
    params after the step as numpy, the state's step, the gradients its
    update applied)."""
    from hgr_tpu_torch.train import init_train_state, make_optimizer
    from hgr_tpu_torch.train.spmd import make_spmd_train_step

    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg = Config(**case["config"])
        tm = TreeModel.build(cfg, _hierarchy(case["hier"]), pad_multiple=64, device="cpu")
        tm.load_state_dict({k: torch.from_numpy(v) for k, v in case["weights"].items()})
        extra_params = extra_labels = text_fn = None
        frozen = ()
        if cfg.coop:
            static, _ = tm.coop_setup(0)
            text_fn = tm.coop_text_fn(static)
            extra_params = {"coop_ctx": torch.tensor(case["coop_ctx"])}
            extra_labels = {"clip": "frozen", "coop_ctx": "clip"}
            frozen = ("clip",)
        tx = make_optimizer(cfg, 10, extra_labels=extra_labels)
        state = init_train_state(tm.model, tm.layer_weight, tx, extra_params=extra_params)
        step = make_spmd_train_step(cfg, tx, make_mesh(*case["mesh"]), dtype=torch.float32,
                                    text_fn=text_fn, frozen=frozen)
        # the gradients the update applies (summed over the world, scaled)
        named = [*tm.model.state_dict(keep_vars=True).items(),
                 ("layer_weight", tm.layer_weight), *(extra_params or {}).items()]
        grads, update = {}, tx.update

        def update_spy(params, st, named=named, grads=grads, update=update):
            grads.update({k: t.grad.numpy().copy() for k, t in named if t.grad is not None})
            return update(params, st)

        tx.update = update_spy
        state, loss = step(state, case["images"], torch.as_tensor(tm.node_tokens).long(),
                           case["sched"])
        params = _params(tm)
        if cfg.coop:
            params["coop_ctx"] = state.params["coop_ctx"].detach().numpy().copy()
        out.append((float(loss), params, state.step, grads))
    return out


def cli_rank(rank, argv):
    """``driver.main(argv)`` on the CPU in this rank's process group: the
    summary of ``run_test``, or the final train state's params."""
    from hgr_tpu_torch import driver

    torch.set_num_threads(1)
    out = driver.main(argv, device="cpu")
    if isinstance(out, dict):
        return out
    params = {k: v.detach().numpy().copy() for k, v in out.params["clip"].state_dict().items()}
    params["layer_weight"] = out.params["layer_weight"].detach().numpy().copy()
    return params


def replay_train_rank(rank, argv, replicas):
    """One process replaying a mesh train run: each step takes ``replicas``
    consecutive batches of the same loader and sampler, the mean of their
    OM losses, one update. Returns (losses, params, the mask of entries
    whose gradient is above 1e-6 at every step)."""
    from hgr_tpu_torch import driver, train

    torch.set_num_threads(1)
    cfg = Config.from_args(argv)
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device="cpu")
    grouped = driver._grouped_split(cfg, cfg.data_split_train, splits[cfg.data_train], splits)
    loader = driver.GroupedTrainLoader(
        grouped, {c: hier.name_to_id[c] for c in grouped},
        driver._image_source(cfg, tm.clip_cfg.image_resolution), cfg.batch_size,
        n_episodes=cfg.n_episodes, seed=cfg.seed, num_threads=1)
    tx = train.make_optimizer(cfg, cfg.epochs * loader.n_episodes)
    loader.n_episodes += (-loader.n_episodes) % replicas
    state = train.init_train_state(tm.model, tm.layer_weight, tx)
    sampler = train.NegativeSampler(hier, tm.train_index, cfg.num_compare, k=cfg.k,
                                    seed=cfg.seed, exclu_bro=cfg.exclu_bro)
    builder = train.ScheduleBuilder(hier, sampler, cfg.out_ratio, cfg.in_ratio, cfg.num_compare,
                                    method=cfg.training_method, strategy=cfg.sample_strategy)
    loss_fn = train.make_om_loss_fn(torch.float32, "OM", cfg.weights, cfg.weighting)
    tokens = torch.as_tensor(tm.node_tokens).long()
    loader.set_epoch(0)
    batches = list(loader)
    loader.close()
    losses, mask = [], None
    for i in range(0, len(batches), replicas):
        params = train.freeze_params(state.params, ())
        loss = torch.stack([loss_fn(params, torch.from_numpy(b.images), tokens,
                                    train.sched_to_device(builder.build(b.target), "cpu"))
                            for b in batches[i: i + replicas]]).mean()
        loss.backward()
        big = {k: v.grad.abs().numpy() > 1e-6 for k, v in
               [*tm.model.state_dict(keep_vars=True).items(), ("layer_weight", tm.layer_weight)]}
        mask = big if mask is None else {k: mask[k] & big[k] for k in big}
        tx.update(params, state.opt_state)
        losses.append(float(loss.detach()))
    params = {k: v.detach().numpy() for k, v in tm.model.state_dict().items()}
    params["layer_weight"] = tm.layer_weight.detach().numpy()
    return losses, params, mask


def stop_rank(rank, n):
    """``any_rank`` over the world (True on every rank when rank ``n``
    asks), and ``host_local_batch_slice(8)``."""
    from hgr_tpu_torch.parallel.distributed import any_rank, host_local_batch_slice

    return any_rank(rank == n, "cpu"), any_rank(False, "cpu"), host_local_batch_slice(8)
