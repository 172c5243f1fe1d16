"""The port's reader of the JAX package's Orbax checkpoints, against the JAX
package, tensorstore and ``zstandard`` (which the tests import; the port
does not) on the CPU:

- ``utils/zstd.py`` equals ``zstandard`` on frames of levels 1, 3 and 19,
  with and without content size and checksum, empty and over 128 KB; a
  hidden ``libzstd.so.1`` fails the read with the library named;
- ``utils/ocdbt.py`` lists and reads what tensorstore does on stores with
  interior nodes, indirect values and a version tree of 40 and more commits;
  a flipped byte in a node fails its CRC;
- ``restore_params`` of JAX-written TEST-RN, TEST-ViT, CoOp, bfloat16 and
  ``model``-sharded checkpoints equals JAX's ``restore_params`` converted by
  ``from_jax_params``, bitwise, and reads no optimizer moment; the CLI's
  ``--load`` eval gives JAX's counts; another architecture is refused;
- ``load_pytree`` of the JAX runner's artifacts equals JAX's, and ``--cnn``
  of JAX's ``_refit`` features as JAX's featurizer does within 1e-4;
- ``--resume`` from a JAX ``clip_0`` (plain and ``accum_steps=2``): one
  step gives JAX's resumed step within the tolerance of
  ``tests/test_torch_train.py::test_optimizer_step_matches_optax``;
- the committed fixtures (``tests/torch_fixtures/make_orbax_fixtures.py``)
  decode to ``digests.json`` through the port's reader and JAX's.
"""

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import tensorstore as ts  # noqa: E402
import zstandard  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu import train as jtrain  # noqa: E402
from hgr_tpu.baselines import cnzsl as jcnzsl  # noqa: E402
from hgr_tpu.baselines import free as jfree  # noqa: E402
from hgr_tpu.baselines import gcn as jgcn  # noqa: E402
from hgr_tpu.baselines.features import make_featurizer as j_make_featurizer  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict as j_convert_state_dict  # noqa: E402
from hgr_tpu.utils import checkpoint as jckpt  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from hgr_tpu_torch import driver, train  # noqa: E402
from hgr_tpu_torch.baselines.features import load_backbone, make_featurizer  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models import clip as tclip  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402
from hgr_tpu_torch.utils import checkpoint, zstd  # noqa: E402
from hgr_tpu_torch.utils import orbax as porbax  # noqa: E402
from hgr_tpu_torch.utils.ocdbt import OcdbtStore  # noqa: E402
from hgr_tpu_torch.utils.zarr import read_meta  # noqa: E402

T = torch.from_numpy
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "orbax"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x):
    """A tensor or array as comparable bytes (bfloat16 as its bits)."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).contiguous().numpy()
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        a = a.view(np.uint16)
    return str(a.dtype), a.shape, a.tobytes()


def _assert_same_tree(got, want, path=""):
    """The port's tree (tensors, Python numbers) equals JAX's (numpy) leaf
    for leaf, bitwise, with the same structure."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got.keys(), want.keys())
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}.{i}")
    elif want is None:
        assert got is None, path
    else:
        assert _bits(got) == _bits(want), path


def _weights(arch, seed=0, cfg=None):
    """(JAX params, the port's state_dict) of one seeded model (the port's
    ``clip_init`` taken into the JAX layout by JAX's ``convert_state_dict``)."""
    cfg = cfg or tclip.get_config(arch)
    sd = tclip.clip_init(cfg, torch.Generator().manual_seed(seed)).state_dict()
    jcfg = jclip.CLIPConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(jclip.CLIPConfig)})
    return j_convert_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg), sd


def _save_state(folder, params, extra=None, labels=None, accum=1):
    cfg = JConfig(arch="TEST-RN", accum_steps=accum)
    tx = jtrain.make_optimizer(cfg, 10, extra_labels=labels)
    # jtrain.init_train_state, its optimizer init in one compile; the
    # synthetic hierarchy's 4 levels
    params = {"clip": params, "layer_weight": jnp.linspace(0.5, 1.5, 4), **(extra or {})}
    state = jtrain.TrainState(params, jax.jit(tx.init)(params), jnp.zeros((), jnp.int32))
    return jckpt.save_checkpoint(str(folder), 0, state)


def test_zstd_matches_zstandard(monkeypatch):
    rng = np.random.default_rng(0)
    payloads = [b"", rng.bytes(1000), rng.integers(0, 4, 300_000, dtype=np.uint8).tobytes()]
    for level in (1, 3, 19):
        for content_size in (True, False):
            for checksum in (True, False):
                c = zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                             write_checksum=checksum)
                for data in payloads:
                    frame = c.compress(data)
                    want = zstandard.ZstdDecompressor().decompress(
                        frame, max_output_size=len(data) + 1)
                    got = zstd.decompress(frame, None if content_size else len(data))
                    assert got.tobytes() == want == data, (level, content_size, checksum)
                    out = np.empty(len(data), np.uint8)
                    assert zstd.decompress(frame, len(data), out=out) is not None
                    assert out.tobytes() == data
    big = zstandard.ZstdCompressor(write_content_size=False).compress(payloads[2])
    with pytest.raises(ValueError, match="decoded to|Destination"):
        zstd.decompress(big, len(payloads[2]) + 8)
    assert zstd.decompress(big, 10**6, exact=False).tobytes() == payloads[2]
    with pytest.raises(ValueError, match="does not say its size"):
        zstd.decompress(big)
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not zstd at all", 10)
    assert zstd.version() >= 10400

    # without the library a checkpoint does not load, and says why
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-hidden.so.1")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(zstd.ZstdUnavailable, match="libzstd-hidden.so.1") as e:
        checkpoint.load_pytree(str(FIXTURES / "rn50_refit"))
    assert "rn50_refit" in str(e.value) and "libzstd1" in str(e.value)


def _ts_write(path, config, commits):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/", "config": config}).result()
    for batch in commits:
        txn = ts.Transaction()
        for key, value in batch:  # a value of None deletes the key
            kv.with_transaction(txn).write(key, value).result()
        txn.commit_async().result()
    return kv


def test_ocdbt_matches_tensorstore(tmp_path):
    """Small nodes and inline values (interior nodes, indirect values, a
    version tree of arity 2 over 70 commits, keys overwritten and deleted),
    and the defaults with uncompressed nodes and a value of 300 KB."""
    rng = np.random.default_rng(0)
    keys = [f"params.layer{i % 7}.w{i}/{i % 3}.0" for i in range(60)]
    small = [[(k, rng.bytes(int(rng.integers(0, 60))))] for k in keys]
    later = [[(k, rng.bytes(40)) for k in keys[:10]], [(k, None) for k in keys[50:55]]]
    cases = {
        "small": ({"max_decoded_node_bytes": 512, "max_inline_value_bytes": 16,
                   "version_tree_arity_log2": 1}, small + later * 5),
        "plain": ({"compression": None},
                  [[(k, rng.bytes(int(rng.integers(0, 3000)))) for k in keys[:20]],
                   [("big/0.0", rng.bytes(300_000)), ("big/.zarray", b"{}")]]),
    }
    for name, (config, commits) in cases.items():
        path = tmp_path / name
        kv = _ts_write(path, config, commits)
        want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
        store = OcdbtStore(str(path))
        assert store.list() == sorted(want), name
        assert {k: store.read(k) for k in store.list()} == want, name
        assert store.list("params.layer3") == sorted(k for k in want
                                                     if k.startswith("params.layer3"))
        if name == "small":
            assert store.generation > len(commits) and len(want) == 55
            assert len(list((path / "d").iterdir())) > 40

    # a flipped byte in the root node, or in the manifest, fails its CRC
    for target in ("node", "manifest"):
        bad = tmp_path / f"bad_{target}"
        shutil.copytree(tmp_path / "small", bad)
        root = OcdbtStore(str(bad)).root_node
        file, at = ((bad / root.file.path, root.offset + root.length // 2) if target == "node"
                    else (bad / "manifest.ocdbt", 20))
        raw = bytearray(file.read_bytes())
        raw[at] ^= 0x10
        file.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="CRC-32C mismatch"):
            OcdbtStore(str(bad))


def test_restore_params_and_cli_load_match_jax(tmp_path, monkeypatch):
    """``restore_params`` of JAX's TEST-RN, TEST-ViT, CoOp (ctx), bfloat16 and
    ``model``-sharded (bfloat16 in part) checkpoints; then the CLI's ``--load`` eval of the
    TEST-RN one against JAX's, and two checkpoints of other architectures."""
    rn, _ = _weights("TEST-RN")
    vit, _ = _weights("TEST-ViT", seed=1)
    half = jax.tree_util.tree_map_with_path(
        lambda p, x: x.astype(jnp.bfloat16) if len(p) % 2 else x, rn)
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))

    def shard(x):
        spec = PartitionSpec("model") if x.ndim and x.shape[0] % 4 == 0 else PartitionSpec()
        return jax.device_put(x, NamedSharding(mesh, spec))

    ckpts = {
        "TEST-RN": _save_state(tmp_path / "rn", rn),
        "TEST-ViT": _save_state(tmp_path / "vit", vit),
        "coop": _save_state(tmp_path / "coop", rn, {"coop_ctx": jnp.arange(32.0).reshape(4, 8)},
                            {"clip": "frozen", "coop_ctx": "clip"}),
        "bf16-sharded": _save_state(tmp_path / "sharded", jax.tree.map(shard, half)),
    }
    store = OcdbtStore(ckpts["bf16-sharded"])
    metas = [read_meta(store, k[:-len("/.zarray")]) for k in store.list("params.")
             if k.endswith("/.zarray")]
    assert any(m["chunks"] != m["shape"] for m in metas), "no multi-chunk array"

    names = []
    real = porbax.read_array
    monkeypatch.setattr(porbax, "read_array", lambda s, n: names.append(n) or real(s, n))
    for case, path in ckpts.items():
        cfg = tclip.get_config("TEST-ViT" if case == "TEST-ViT" else "TEST-RN")
        want = jckpt.restore_params(path)
        got = checkpoint.restore_params(path, cfg)
        assert set(got) == set(want), case
        want_sd = from_jax_params(_np(want["clip"]), cfg)
        assert list(got["clip"]) == list(want_sd), case
        for k, v in want_sd.items():
            assert got["clip"][k].dtype == torch.float32 and torch.equal(got["clip"][k], v), k
        for k in set(want) - {"clip"}:
            assert _bits(got[k]) == _bits(want[k]), (case, k)
    assert names and not [n for n in names if not n.startswith("params.")]
    monkeypatch.undo()

    # the CLI's --load eval: JAX's build_model (without the random draws that
    # --load replaces) and run_test; the port's main
    monkeypatch.setattr(JTreeModel, "init_params", lambda self, seed: None)
    argv = ["--synthetic", "True", "--arch", "TEST-RN", "--train", "False", "--dtype", "float32",
            "--load", "True", "--load_path", ckpts["TEST-RN"], "--max_test_batches", "3",
            "--test_batch_size", "8", "--folder", str(tmp_path / "eval")]
    jcfg = JConfig.from_args(argv)
    jhier, jsplits = jdriver.build_hierarchy(jcfg)
    jtm = jdriver.build_model(jcfg, jhier, jsplits)
    want = jdriver.run_test(jcfg, jtm, jsplits, JRunLogger(jcfg.save_path, echo=False))
    got = driver.main(argv, device="cpu")
    assert got["num_samples"] == want["num_samples"] == 24
    for key in ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20", "tor"):
        assert got[key] == want[key], key
    for key in ("path_ratio", "point_ratio"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key

    cfg = Config.from_args(argv)
    hier, splits = driver.build_hierarchy(cfg)
    with pytest.raises(ValueError, match="not a CLIP tree of the model's architecture"):
        driver.build_model(dataclasses.replace(cfg, arch="TEST-ViT"), hier, splits, device="cpu")
    wide = dataclasses.replace(tclip.get_config("TEST-RN"), embed_dim=48)
    other = _save_state(tmp_path / "wide", _weights("TEST-RN", cfg=wide)[0])
    with pytest.raises(RuntimeError, match="not a checkpoint of --arch TEST-RN"):
        driver.build_model(dataclasses.replace(cfg, load_path=other), hier, splits, device="cpu")


def _runner_artifacts(tmp_path):
    """The trees the JAX runner saves for CNZSL, GCN and FREE
    (``hgr_tpu/baselines/run.py:348``, ``:412``, ``:517``), at small widths,
    through JAX's ``save_pytree``."""
    key = jax.random.PRNGKey(0)
    params, state = jcnzsl.cnzsl_init(key, jcnzsl.CNZSLConfig(attr_dim=8, proto_dim=16,
                                                              hid_dim=32))
    gcn = jgcn.gcn_init(key, jgcn.GCNConfig(n=20, in_channels=8, out_channels=16,
                                            hidden_layers="d32,d"))
    free = jfree.free_init(key, jfree.FREEConfig(res_size=16, att_size=8, latent_size=8,
                                                 ngh=32, ndh=32, nclass_seen=10))
    trees = {"cnzsl": {"params": params, "state": state},
             "gcn": {"params": gcn, "pred": jax.random.normal(key, (20, 16))},
             "free": {"params": free, "classifier": jfree._linear(key, 16, 20)}}
    return {name: jckpt.save_pytree(str(tmp_path / name), tree) for name, tree in trees.items()}


def test_load_pytree_and_cnn_match_jax(tmp_path):
    """The JAX runner's CNZSL, GCN and FREE artifacts and the committed
    ``_refit`` one; ``--cnn`` of the ``_refit`` features within 1e-4 of the
    JAX featurizer on its params (the JAX package's own ``load_backbone``
    hands the featurizer the whole ``{"params", "trlog"}`` tree)."""
    arts = {"refit": str(FIXTURES / "rn50_refit"), **_runner_artifacts(tmp_path)}
    for name, path in arts.items():
        got, want = checkpoint.load_pytree(path), jckpt.load_pytree(path)
        _assert_same_tree(got, _np(want), name)
        if name == "refit":
            assert isinstance(got["trlog"]["loss"][0], float)

    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    model = load_backbone(arts["refit"])
    got = make_featurizer(model, crop=56, dtype=torch.float32)(images).numpy()
    want = np.asarray(j_make_featurizer(jckpt.load_pytree(arts["refit"])["params"], crop=56,
                                        dtype=jnp.float32)(images))
    assert got.shape == (2, 2048) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _resume_case(tmp_path, accum):
    """JAX takes one train step (with ``accum_steps=2``, one micro-step) and
    saves; the port restores that ``clip_0`` into a fresh state, and both
    take the next step."""
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    over = dict(arch="TEST-ViT", dtype="float32", num_compare=6, lr=1e-3, w_lr=1e-2,
                grad_clip=0.5, accum_steps=accum)
    cfg, jcfg = Config(**over), JConfig(**over)
    tm = TreeModel.build(cfg, hier, pad_multiple=64, device="cpu")
    tm.init_params(0)
    jparams, sd = _weights("TEST-ViT", seed=2)
    target = int(hier.level(hier.max_depth)[3])
    scheds = []
    for mod, h in ((train, hier), (jtrain, jhier)):
        s = mod.NegativeSampler(h, tm.train_index, 6, seed=0)
        scheds.append(mod.ScheduleBuilder(h, s, cfg.out_ratio, cfg.in_ratio, 6).build(target))
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    tokens = np.asarray(tm.node_tokens)

    jtx = jtrain.make_optimizer(jcfg, 10)
    jstate = jtrain.init_train_state(jparams, jnp.linspace(0.5, 1.5, tm.layer_weight.numel()),
                                     jtx)
    jstep = jtrain.make_train_step(jcfg, jclip.get_config("TEST-ViT"), jtx, dtype=jnp.float32,
                                   donate=False)
    jsched = jtrain.sched_to_device(scheds[1])
    jstate, _ = jstep(jstate, jnp.asarray(images[0]), jnp.asarray(tokens), jsched)
    path = jckpt.save_checkpoint(str(tmp_path / f"accum{accum}"), 0, jstate)
    jnext, jloss = jstep(jstate, jnp.asarray(images[1]), jnp.asarray(tokens), jsched)

    tx = train.make_optimizer(cfg, 10)
    state = train.init_train_state(tm.model, tm.layer_weight, tx)
    state = checkpoint.restore_checkpoint(path, state)
    assert state.step == 1 and state.opt_state.count == (1 if accum == 1 else 0)
    assert state.opt_state.mini_step == (0 if accum == 1 else 1)
    if accum == 1:  # AdamW's moments, converted as the params are
        mu = from_jax_params(_np(jstate.opt_state.inner_states["clip"].inner_state[1][0]
                                 .mu["clip"]), tm.clip_cfg)
        got = state.opt_state.adamw.state_dict()["state"]
        for i, (k, p) in enumerate(tm.model.state_dict().items()):
            assert torch.equal(got[i]["exp_avg"], mu[k]) and float(got[i]["step"]) == 1.0, k
            # fused AdamW (the card's) takes moments of their params' strides
            assert got[i]["exp_avg"].stride() == got[i]["exp_avg_sq"].stride() == p.stride(), k
    step = train.make_train_step(cfg, tx, dtype=torch.float32)
    state, loss = step(state, T(images[1]), T(tokens).long(),
                       train.sched_to_device(scheds[0], "cpu"))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert state.step == 2 and state.opt_state.count == 1 + (accum == 1)
    want = from_jax_params(_np(jnext.params["clip"]), tm.clip_cfg)
    for k, v in tm.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=5e-3, atol=3e-5, msg=k)
    assert not torch.equal(tm.model.state_dict()["logit_scale"], sd["logit_scale"])
    torch.testing.assert_close(tm.layer_weight.detach(), T(np.array(jnext.params["layer_weight"])),
                               rtol=5e-3, atol=3e-5)
    return path, cfg, tm


def test_resume_matches_jax(tmp_path):
    """Plain and ``accum_steps=2``; a checkpoint of the other kind raises,
    naming ``MultiSteps``."""
    path, _, _ = _resume_case(tmp_path, 1)
    _, cfg2, tm2 = _resume_case(tmp_path, 2)
    state = train.init_train_state(tm2.model, tm2.layer_weight, train.make_optimizer(cfg2, 10))
    with pytest.raises(ValueError, match="MultiSteps"):
        checkpoint.restore_checkpoint(path, state)


def _digest(x):
    dtype = (str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor)
             else str(np.asarray(x).dtype))
    _, shape, raw = _bits(x)
    return {"dtype": dtype, "shape": list(shape), "sha256": hashlib.sha256(raw).hexdigest()}


def test_committed_fixtures_match_digests():
    """Every leaf of both fixtures through the port's reader, the RN50 params
    through JAX's ``restore_params`` and the ``_refit`` tree through JAX's
    ``load_pytree``: each the dtype, shape and SHA-256 of ``digests.json``."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    for name, want in digests.items():
        leaves = porbax.read_leaves(str(FIXTURES / name))
        got = {".".join(map(str, k)): _digest(v) for k, v in leaves.items()
               if not isinstance(v, (type(None), tuple, list, dict))}
        assert got == want, name
        del leaves
    jparams = jax.tree_util.tree_flatten_with_path(
        jckpt.restore_params(str(FIXTURES / "rn50" / "clip_0")))[0]
    for kpath, leaf in jparams:
        name = "params." + ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kpath)
        assert _digest(np.asarray(leaf)) == digests["rn50/clip_0"][name], name
    assert len(jparams) == sum(k.startswith("params.") for k in digests["rn50/clip_0"])
    refit = jax.tree_util.tree_flatten_with_path(jckpt.load_pytree(str(FIXTURES / "rn50_refit")))
    for kpath, leaf in refit[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kpath)
        assert _digest(leaf) == digests["rn50_refit"][name], name
