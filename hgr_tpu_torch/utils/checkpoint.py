"""Training checkpoints (port of ``hgr_tpu/utils/checkpoint.py:22-210``).

Params, optimizer state and step are saved together (the reference saves
only the weights, ``model/clip_tree.py:76-78``) under the reference's path
convention ``{folder}/{exp_name}/{weights}_{out_ratio}_{in_ratio}/clip_{epoch}``.
The format is the port's own: ``clip_{epoch}/state.pt``, one ``torch.save``
of ``{"params", "opt_state", "step"}`` with every tensor on the CPU, and the
``clip_{epoch}.meta.json`` sidecar for mid-epoch resume. ``restore_params``
reads the weights alone, for ``--load`` and ``--fetch`` (``hgr_tpu/utils/
checkpoint.py:152-163``); ``save_pytree``/``load_pytree`` keep the
baselines' artifacts in the same format. Reading the JAX package's Orbax
checkpoints is not ported yet; OpenAI ``.pt`` files load through
``models/convert.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(save_path: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(save_path, f"clip_{epoch}"))


def _to_cpu(x: Any) -> Any:
    """A copy of a nest of dicts, lists and tensors with every tensor
    copied to the CPU, so later in-place updates cannot reach it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


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
    """Load ``{path}/state.pt`` into the TrainState ``like`` in place (its
    module, tensors and optimizer take the saved values on their own
    devices) and return it."""
    payload = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                         map_location="cpu", weights_only=True)
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


def restore_params(path: str) -> dict:
    """The params alone (``{"clip": state_dict, "layer_weight": tensor}``,
    on the CPU) of the checkpoint directory ``path``: the test and
    warm-start path (``--load``, ``--fetch``), which needs no optimizer."""
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f"{path} is not a checkpoint of hgr_tpu_torch (no {STATE_FILE}; expected a "
            "clip_<epoch> directory, e.g. {folder}/{exp_name}/{weights}_{out}_{in}/clip_3)")
    return torch.load(file, map_location="cpu", weights_only=True)["params"]


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
    Orbax)."""
    return _write(os.path.abspath(path), _to_cpu(tree))


def load_pytree(path: str) -> Any:
    """The tree :func:`save_pytree` wrote, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)
