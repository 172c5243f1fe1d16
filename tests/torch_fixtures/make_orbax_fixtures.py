"""Write the JAX package's Orbax checkpoints that the port's reader is held
to, on the CPU and on the card (``chip_smoke.py`` phase "orbax"):

    python tests/torch_fixtures/make_orbax_fixtures.py

Written by the JAX package's own writers into ``tests/torch_fixtures/orbax/``:

- ``rn50/clip_0``: ``utils.checkpoint.save_checkpoint`` of an RN50
  ``init_train_state`` at full width, with its optax state (AdamW's ``mu``
  and ``nu`` seeded and the counts set to 7, so that a resumed step differs
  from a fresh one);
- ``rn50_refit``: ``utils.checkpoint.save_pytree`` of ``{"params":
  resnet50_init(...), "trlog": {...}}``, as the baselines runner writes its
  ``{save_path}_refit`` (``hgr_tpu/baselines/run.py:748``);
- ``digests.json``: each array and number leaf's dtype, shape and SHA-256
  (of its little-endian bytes; bfloat16 as its uint16 bits);
- ``expected.npz``: JAX's fp32 features on the CPU for 8 seeded images
  (CLIP RN50 and ResNet-50) and 64 seeded prompts, and the SHA-256 of those
  inputs, which :func:`inputs` makes from numpy seeds alone.

To keep the folder small enough to commit (under 3 MB), every leaf of 4,096
elements or more repeats the first 1,021 of its own seeded values: 1,021 is
prime, so a chunk read out of order or at a wrong offset cannot match.
Smaller leaves (biases, norms, BatchNorm statistics) stay as seeded, so the
networks stay numerically sane. A rerun writes the same digests.
"""

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = Path(__file__).resolve().parent
OUT = HERE / "orbax"
sys.path.insert(0, str(HERE.parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from hgr_tpu import train as jtrain  # noqa: E402
from hgr_tpu.config import Config  # noqa: E402
from hgr_tpu.models.clip import clip_init, encode_image, encode_text, get_config  # noqa: E402
from hgr_tpu.models.resnet_std import resnet50_features, resnet50_init  # noqa: E402
from hgr_tpu.utils.checkpoint import save_checkpoint, save_pytree  # noqa: E402

PERIOD, TILE_MIN = 1021, 4096
N_IMAGES, N_PROMPTS, IMAGE_SEED, PROMPT_SEED = 8, 64, 11, 12
RESUMED_STEP = 7
LEVELS = 13  # the levels of chip_smoke.py's hierarchy (LEVEL_SIZES): layer_weight's length


def tile(x):
    """A leaf of ``TILE_MIN`` elements or more as its first ``PERIOD``
    values repeated; a smaller one as it is."""
    x = np.asarray(x)
    if x.size < TILE_MIN:
        return x
    return np.resize(x.reshape(-1)[:PERIOD], x.size).reshape(x.shape).astype(x.dtype)


def inputs(resolution=224, context_length=77, vocab_size=49408):
    """The seeded inputs: uint8 images ``[8, R, R, 3]`` and prompt tokens
    ``[64, T]`` (start token, 1-30 ids, end token - the highest id, where
    the text tower reads - then zeros). ``chip_smoke.py`` makes the same."""
    images = np.random.default_rng(IMAGE_SEED).integers(
        0, 256, (N_IMAGES, resolution, resolution, 3), dtype=np.uint8)
    rng = np.random.default_rng(PROMPT_SEED)
    tokens = np.zeros((N_PROMPTS, context_length), np.int32)
    for row in tokens:
        n = int(rng.integers(1, 31))
        row[0] = vocab_size - 2
        row[1:n + 1] = rng.integers(1, vocab_size - 2, n)
        row[n + 1] = vocab_size - 1
    return images, tokens


def digest(x):
    a = np.asarray(x, order="C")
    dtype = str(a.dtype)
    if dtype == "bfloat16":
        a = a.view(np.uint16)
    return {"dtype": dtype, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def digests(tree):
    """``{dotted key path: digest}`` of every array and number leaf."""
    out = {}
    for kpath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in kpath)
        out[name] = digest(leaf)
    return out


def rn50_state():
    cfg = get_config("RN50")
    params = jax.tree.map(tile, jax.jit(clip_init, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(jnp.asarray, params)
    layer_weight = jnp.asarray(np.linspace(0.5, 1.5, LEVELS, dtype=np.float32))
    tx = jtrain.make_optimizer(Config(arch="RN50"), 100)
    state = jtrain.init_train_state(params, layer_weight, tx)
    # AdamW's moments and counts of a later step: seeded, on a grid of
    # quarter steps, every leaf repeating its first 61 values (a prime) so
    # that the moments add little to the folder; nu > 0
    rng = np.random.default_rng(1)

    def moments(x, square):
        v = 1e-3 * np.round(4 * rng.standard_normal(61)).astype(np.float32) / 4
        v = np.resize(v * v + 1e-8 if square else v, np.size(x)).reshape(np.shape(x))
        return jnp.asarray(v.astype(np.float32))

    def later(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            fields = {f: getattr(node, f) for f in node._fields}
            if {"count", "mu", "nu"} <= set(fields):
                return node._replace(
                    count=jnp.asarray(RESUMED_STEP, jnp.int32),
                    mu=jax.tree.map(lambda x: moments(x, False), fields["mu"]),
                    nu=jax.tree.map(lambda x: moments(x, True), fields["nu"]))
            if set(fields) == {"count"}:  # the schedule's
                return node._replace(count=jnp.asarray(RESUMED_STEP, jnp.int32))
            return type(node)(*(later(v) for v in node))
        if isinstance(node, tuple):
            return tuple(later(v) for v in node)
        if isinstance(node, dict):
            return {k: later(v) for k, v in node.items()}
        return node

    state = state._replace(opt_state=later(state.opt_state),
                           step=jnp.asarray(RESUMED_STEP, jnp.int32))
    return cfg, state


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    cfg, state = rn50_state()
    save_checkpoint(str(OUT / "rn50"), 0, state)
    key = jax.random.PRNGKey(1)
    refit = {
        "params": jax.tree.map(lambda x: jnp.asarray(tile(x)), resnet50_init(key)),
        "trlog": {"loss": [2.5, 1.75], "acc": [0.125, 0.375],
                  "step_loss": [jnp.float32(2.75), jnp.float32(1.5)]},
    }
    save_pytree(str(OUT / "rn50_refit"), refit)
    all_digests = {
        "rn50/clip_0": digests({"params": state.params, "opt_state": state.opt_state,
                                "step": state.step}),
        "rn50_refit": digests(refit),
    }
    (OUT / "digests.json").write_text(
        json.dumps(all_digests, sort_keys=True, separators=(",", ":")) + "\n")

    images, tokens = inputs(cfg.image_resolution, cfg.context_length, cfg.vocab_size)
    clip = state.params["clip"]
    image_feats = jax.jit(lambda x: encode_image(clip, cfg, x, dtype=jnp.float32))(images)
    text_feats = jax.jit(lambda t: encode_text(clip, cfg, t, dtype=jnp.float32))(tokens)
    resnet = refit["params"]
    from hgr_tpu.baselines.features import preprocess_for_backbone

    resnet_feats = jax.jit(lambda x: resnet50_features(
        resnet, preprocess_for_backbone(x, 224), dtype=jnp.float32))(images)
    np.savez_compressed(
        OUT / "expected.npz",
        image_feats=np.asarray(image_feats), text_feats=np.asarray(text_feats),
        resnet_feats=np.asarray(resnet_feats),
        images_sha256=np.asarray(hashlib.sha256(images.tobytes()).hexdigest()),
        tokens_sha256=np.asarray(hashlib.sha256(tokens.tobytes()).hexdigest()))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
