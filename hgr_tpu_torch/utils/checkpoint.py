"""Training checkpoints (port of ``hgr_tpu/utils/checkpoint.py:22-210``).

Params, optimizer state and step are saved together (the reference saves
only the weights, ``model/clip_tree.py:76-78``) under the reference's path
convention ``{folder}/{exp_name}/{weights}_{out_ratio}_{in_ratio}/clip_{epoch}``.
The port writes its own format: ``clip_{epoch}/state.pt``, one
``torch.save`` of ``{"params", "opt_state", "step"}`` with every tensor on
the CPU, and the ``clip_{epoch}.meta.json`` sidecar for mid-epoch resume;
``save_pytree`` keeps the baselines' artifacts in the same format.

It reads that format and the JAX package's Orbax directories
(``_METADATA`` and ``manifest.ocdbt``, read by ``utils/orbax.py`` without
JAX): ``restore_params`` reads the weights alone, for ``--load`` and
``--fetch`` (``hgr_tpu/utils/checkpoint.py:152-163``), converting a JAX
CLIP tree with ``models/convert.from_jax_params``; ``restore_checkpoint``
also carries optax's state into the port's ``OptState`` for ``--resume``;
``load_pytree`` reads either kind of artifact. OpenAI ``.pt`` files load
through ``models/convert.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch

from . import orbax
from .orbax import is_orbax_dir

STATE_FILE = "state.pt"


def _ckpt_dir(save_path: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(save_path, f"clip_{epoch}"))


def _map(fn, x: Any) -> Any:
    """``fn`` applied to every leaf of a nest of dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def _to_cpu(x: Any) -> Any:
    """A copy of a nest of dicts, lists and tensors with every tensor
    copied to the CPU, so later in-place updates cannot reach it."""
    return _map(lambda t: t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
                else t, x)


def _payload(state: Any) -> dict:
    """``{"params", "opt_state", "step"}`` of a TrainState, on the CPU: the
    CLIP module as its ``state_dict``, the other params as tensors."""
    params = {k: v.state_dict() if isinstance(v, torch.nn.Module) else v
              for k, v in state.params.items()}
    return _to_cpu({"params": params, "opt_state": state.opt_state.state_dict(),
                    "step": int(state.step)})


def _write(path: str, payload: dict) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # all or nothing
    return path


def save_checkpoint(save_path: str, epoch: int, state: Any) -> str:
    """Save a TrainState to ``{save_path}/clip_{epoch}`` and wait for it."""
    return _write(_ckpt_dir(save_path, epoch), _payload(state))


class AsyncCheckpointSaver:
    """Overlap checkpoint disk I/O with the next epoch's compute.

    ``save`` copies the state to the CPU before it returns (so the next
    steps' in-place updates cannot reach it) and writes it in a background
    thread; it first waits for the previous write, so at most one is
    outstanding. ``close()`` (or leaving the ``with`` block) waits for the
    last. ``keep=N`` retains only the N newest checkpoints (0 keeps all);
    pruning runs only over writes already finished, so a crash never leaves
    fewer than ``keep`` complete checkpoints.
    """

    def __init__(self, keep: int = 0):
        self.keep = int(keep)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._last_path: Optional[str] = None

    def _wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # re-raises a failed write

    def _prune(self, save_path: str) -> None:
        if self.keep <= 0 or not os.path.isdir(save_path):
            return
        epochs = sorted(
            int(n.split("_", 1)[1])
            for n in os.listdir(save_path)
            if n.startswith("clip_") and n.split("_", 1)[1].isdigit()
        )
        for e in epochs[: -self.keep]:
            shutil.rmtree(_ckpt_dir(save_path, e), ignore_errors=True)
            try:
                os.remove(_ckpt_dir(save_path, e) + ".meta.json")
            except FileNotFoundError:
                pass

    def save(self, save_path: str, epoch: int, state: Any,
             meta: Optional[dict] = None) -> str:
        self._wait()
        self._prune(save_path)  # everything on disk is complete now
        path = _ckpt_dir(save_path, epoch)
        self._pending = self._pool.submit(_write, path, _payload(state))
        if meta is not None:
            # sidecar for mid-epoch resume ({steps_done, steps_per_epoch}),
            # written at once: it is tiny
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f)
        self._last_path = save_path
        return path

    def close(self) -> None:
        try:
            self._wait()
            if self._last_path:
                self._prune(self._last_path)
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_checkpoint(path: str, like: Any) -> Any:
    """Load the checkpoint ``path`` into the TrainState ``like`` in place (its
    module, tensors and optimizer take the saved values on their own
    devices) and return it: the port's ``state.pt``, or the JAX package's
    Orbax ``clip_{epoch}`` with optax's state carried over
    (:func:`_carry_optax`)."""
    path = os.path.abspath(path)
    if is_orbax_dir(path):
        payload = _carry_optax(path, orbax.read_tree(path), like)
    else:
        payload = torch.load(_state_file(path), map_location="cpu", weights_only=True)
    with torch.no_grad():
        for key, value in like.params.items():
            saved = payload["params"][key]
            if isinstance(value, torch.nn.Module):
                value.load_state_dict(saved)
            else:
                value.copy_(saved)
    like.opt_state.load_state_dict(payload["opt_state"])
    like.step = int(payload["step"])
    return like


def _state_file(path: str) -> str:
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f"{path} is not a checkpoint of hgr_tpu_torch ({STATE_FILE}) or of hgr_tpu (Orbax: "
            "_METADATA and manifest.ocdbt); expected a clip_<epoch> directory, e.g. "
            "{folder}/{exp_name}/{weights}_{out}_{in}/clip_3")
    return file


def _convert_clip(jax_tree: Any, clip_cfg: Any, what: str) -> dict:
    """A JAX CLIP tree as the ``state_dict`` of a model of ``clip_cfg``."""
    from ..models.convert import from_jax_params

    def fp32(t):  # numpy, which the conversion goes through, has no bfloat16
        return t.float() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 else t

    try:
        return from_jax_params(_map(fp32, jax_tree), clip_cfg)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{what}: not a CLIP tree of the model's architecture ({clip_cfg}): "
                         f"no {e}") from e


def _from_jax(value: Any, jax_tree: Any, what: str) -> Any:
    """A JAX params entry in the port's form for the params entry
    ``value``: a CLIP tree as the module's ``state_dict``, a tensor as
    itself."""
    if isinstance(value, torch.nn.Module):
        return _convert_clip(jax_tree, value.cfg, what)
    return jax_tree


def _carry_optax(path: str, tree: dict, like: Any) -> dict:
    """The port's checkpoint payload (``{"params", "opt_state", "step"}``,
    as ``state.pt`` holds it) of the JAX TrainState ``tree``, laid out for
    the TrainState ``like``.

    The JAX optimizer (``hgr_tpu/train/trainer.py:50-65``) is
    ``multi_transform({"clip": chain(clip_by_global_norm, adamw), "lw": sgd,
    "frozen": set_to_zero})``, in ``MultiSteps`` under ``accum_steps > 1``.
    Each params entry takes the label of the optimizer that holds its
    tensors in ``like``. AdamW's ``mu``/``nu`` have the params' structure
    and convert as the params do; its count is each tensor's ``step``.
    ``MultiSteps``' accumulated gradients and mini-step, the schedule's
    count and ``step`` carry over. A label whose state cannot be carried
    exactly (another grouping, SGD momentum, accumulation on one side
    only) raises ``ValueError`` naming it."""
    from ..train.trainer import leaves

    st = like.opt_state
    adam_ids = [id(p) for g in st.adamw.param_groups for p in g["params"]] if st.adamw else []
    sgd_ids = {id(p) for g in st.sgd.param_groups for p in g["params"]} if st.sgd else set()
    labels = {}
    for key, value in like.params.items():
        first = id(leaves(value)[0])
        labels[key] = "clip" if first in adam_ids else "lw" if first in sgd_ids else "frozen"
    jparams = tree["params"]
    if set(jparams) != set(like.params):
        raise ValueError(f"{path}: params {sorted(jparams)}, the model has {sorted(like.params)}")
    params = {k: _from_jax(v, jparams[k], f"{path}: params.{k}") for k, v in like.params.items()}

    def flat(key: str, entry: Any) -> list:  # a params entry's tensors in the port's order
        value = like.params[key]
        if isinstance(value, torch.nn.Module):
            return [entry[name] for name in value.state_dict()]
        return [entry]

    opt = tree["opt_state"]
    multi = isinstance(opt, dict) and "inner_opt_state" in opt
    if multi != bool(st.acc):
        raise ValueError(f"{path}: the checkpoint was saved {'with' if multi else 'without'} "
                         "gradient accumulation (optax.MultiSteps), the run has "
                         f"accum_steps {'1' if multi else '> 1'}")
    inner = opt["inner_opt_state"] if multi else opt
    states = inner.get("inner_states", {}) if isinstance(inner, dict) else {}
    if set(labels.values()) - set(states):
        raise ValueError(f"{path}: labels {sorted(set(labels.values()) - set(states))} have no "
                         "optimizer state in the checkpoint")
    opt_sd = st.state_dict()
    count = 0
    for label in sorted(set(labels.values())):
        state = states[label]["inner_state"]
        keys = [k for k in like.params if labels[k] == label]
        if label == "clip":
            try:
                adam, decay, sched = state[1]
                mu, nu, count = adam["mu"], adam["nu"], int(adam["count"])
                if state[0] is not None or decay is not None or int(sched["count"]) != count:
                    raise ValueError
            except (TypeError, KeyError, ValueError):
                raise ValueError(f"{path}: label 'clip': not the state of chain("
                                 "clip_by_global_norm, adamw) with one count") from None
            trained = [k for k in like.params if k in mu and mu[k] is not None]
            if trained != keys:
                raise ValueError(f"{path}: label 'clip': AdamW holds {trained} in the "
                                 f"checkpoint, {keys} in the run")
            moments = [(m, v) for k in keys
                       for m, v in zip(flat(k, _from_jax(like.params[k], mu[k], path)),
                                       flat(k, _from_jax(like.params[k], nu[k], path)))]
            params_ = [p for g in st.adamw.param_groups for p in g["params"]]

            def like_param(x, p):  # fused AdamW takes moments of its params' strides
                return torch.empty_like(p, device="cpu").copy_(x)

            opt_sd["adamw"]["state"] = {
                i: {"step": torch.tensor(float(count)), "exp_avg": like_param(m, p),
                    "exp_avg_sq": like_param(v, p)}
                for i, ((m, v), p) in enumerate(zip(moments, params_))}
        elif state is not None and any(x is not None for x in state):
            raise ValueError(f"{path}: label {label!r} has optimizer state (SGD momentum?), "
                             "which the port's optimizer does not keep")
    if multi:
        if int(opt["gradient_step"]) != count:
            raise ValueError(f"{path}: MultiSteps gradient_step {int(opt['gradient_step'])}, "
                             f"AdamW count {count}")
        acc = opt["acc_grads"]
        opt_sd["acc"] = [t for label in ("clip", "lw") for k in like.params
                         if labels[k] == label
                         for t in flat(k, _from_jax(like.params[k], acc[k], path))]
        opt_sd["mini_step"] = int(opt["mini_step"])
    opt_sd["count"] = count
    return {"params": params, "opt_state": opt_sd, "step": int(tree["step"])}


def restore_params(path: str, clip_cfg: Any = None) -> dict:
    """The params alone (``{"clip": state_dict, "layer_weight": tensor}``,
    and ``"coop_ctx"`` after CoOp training, on the CPU) of the checkpoint
    directory ``path``: the test and warm-start path (``--load``,
    ``--fetch``), which needs no optimizer. A JAX Orbax checkpoint is read
    without its optimizer state and its CLIP tree converted for
    ``clip_cfg``, the model's ``CLIPConfig``."""
    path = os.path.abspath(path)
    if not is_orbax_dir(path):
        return torch.load(_state_file(path), map_location="cpu", weights_only=True)["params"]
    if clip_cfg is None:
        raise ValueError(f"{path}: a JAX checkpoint needs the model's CLIPConfig to convert")
    params = orbax.read_tree(path, ("params",))
    params["clip"] = _convert_clip(params["clip"], clip_cfg, f"{path}: params.clip")
    return params


def read_ckpt_meta(save_path: str, epoch: int) -> Optional[dict]:
    """The ``clip_{epoch}.meta.json`` sidecar ({steps_done,
    steps_per_epoch}) written by :class:`AsyncCheckpointSaver`, or None."""
    try:
        with open(_ckpt_dir(save_path, epoch) + ".meta.json") as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def latest_epoch(save_path: str) -> Optional[int]:
    """Highest ``clip_{epoch}`` under ``save_path``, or None."""
    if not os.path.isdir(save_path):
        return None
    best = None
    for name in os.listdir(save_path):
        if name.startswith("clip_"):
            try:
                e = int(name.split("_", 1)[1])
            except ValueError:
                continue
            best = e if best is None else max(best, e)
    return best


def save_pytree(path: str, tree: Any) -> str:
    """Save a nest of dicts, lists and tensors (the baselines' artifacts:
    GCN params and predicted classifiers, the reference's ``.pth`` and
    ``.pred`` pair, ``baseline/DGP/train_gcn_dense_att.py:13-15``) as
    ``{path}/state.pt``, every tensor on the CPU; returns the directory.
    The port's own format (``hgr_tpu/utils/checkpoint.py:212-222`` writes
    Orbax, which :func:`load_pytree` reads too)."""
    return _write(os.path.abspath(path), _to_cpu(tree))


def load_pytree(path: str) -> Any:
    """The tree :func:`save_pytree` wrote, or the JAX package's
    ``save_pytree`` wrote (Orbax), on the CPU."""
    path = os.path.abspath(path)
    if is_orbax_dir(path):
        return orbax.read_tree(path)
    return torch.load(_state_file(path), map_location="cpu", weights_only=True)
