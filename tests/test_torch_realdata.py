"""The port on real input files against the JAX package, on the CPU in fp32.

- checkpoints: an OpenAI-layout ``.pt`` (a plain ``state_dict`` with
  BatchNorm's ``num_batches_tracked``, and a TorchScript archive) at
  TEST-RN and TEST-ViT widths: ``sniff_config`` equal, and the image and
  text features of ``TreeModel.load_torch`` within rtol 1e-4 + atol 1e-5;
  ``models/zoo.py``'s load and sha256 check;
- the cycle of ``tests/test_e2e_realdata.py`` through ``driver.main`` over
  a JPEG tree with one corrupt file, ``graph_edges_cls.json``, the splits
  and the binary train manifest: training from JAX's initial weights
  (carried in with ``--fetch``) follows JAX's losses within 1e-4; the port
  tests its own ``clip_0`` with ``--load``; and JAX's trained weights,
  carried into a port checkpoint, give JAX's metric counts exactly over
  the files, through a decode cache (byte for byte JAX's) and with
  ``--k_shots``;
- ``--num_proc_workers 2`` (files decoded by spawned processes): each
  loader and the cache build it reaches makes a live decode pool; the
  training run follows JAX's losses, the test gives the threads' and JAX's
  counts, the cache is byte for byte JAX's, and flat fine-tuning gives the
  threads' losses exactly;
- ``classify_files`` and ``python -m hgr_tpu_torch.serve`` on those
  weights: ids exact, scores within 1e-4 (the CLI's, printed to 4
  decimals, within 1.5e-4: one rounding step apart at most).

The JAX runs pass ``--mesh_data 1``: ``tests/conftest.py`` gives JAX eight
CPU devices, on which it would shard.
"""

import dataclasses
import hashlib
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu import driver as jdriver  # noqa: E402
from hgr_tpu import serve as jserve  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models import convert as jconvert  # noqa: E402
from hgr_tpu.models import zoo as jzoo  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu.utils.checkpoint import restore_params as j_restore_params  # noqa: E402
from hgr_tpu_torch import driver, serve  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.data.manifest_index import build_index  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models import clip as tclip  # noqa: E402
from hgr_tpu_torch.models import convert, zoo  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
COUNTS = ("hit@1", "hit@2", "hit@5", "hit@10", "hit@20", "tor", "num_samples")
RATIOS = ("path_ratio", "point_ratio")

# ---- checkpoints -------------------------------------------------------------

# text width 128 so that sniff_config's width // 64 gives the 2 heads
WIDTHS = {"TEST-RN": dict(transformer_width=128, transformer_heads=2),
          "TEST-ViT": dict(transformer_width=128, transformer_heads=2)}


class _Archive(torch.nn.Module):
    """A TorchScript-traceable holder of a CLIP's tensors under OpenAI's
    names, with BatchNorm's ``num_batches_tracked`` as OpenAI's have it."""

    def __init__(self, clip):
        super().__init__()
        for name, child in clip.named_children():
            self.add_module(name, child)
        for name, p in clip.named_parameters(recurse=False):
            self.register_parameter(name, p)
        for m in self.modules():
            if hasattr(m, "running_mean"):
                m.register_buffer("num_batches_tracked", torch.tensor(7))

    def forward(self, x):
        return x * self.logit_scale


def _openai_files(tmp_path, arch):
    jcfg = dataclasses.replace(jclip.get_config(arch), **WIDTHS[arch])
    params = jax.tree.map(np.asarray, jclip.clip_init(jax.random.PRNGKey(5), jcfg))
    sd = from_jax_params(params, jcfg)
    plain = dict(sd)
    for k in [k for k in sd if k.endswith("running_mean")]:
        plain[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(3)
    torch.save(plain, tmp_path / "plain.pt")
    clip = tclip.CLIP(tclip.CLIPConfig(**dataclasses.asdict(jcfg)))
    clip.load_state_dict(sd)
    torch.jit.trace(_Archive(clip), torch.zeros(())).save(str(tmp_path / "archive.pt"))
    return jcfg


def test_load_torch_matches_jax(tmp_path, monkeypatch):
    """Every configuration of ``WIDTHS`` (TEST-RN and TEST-ViT)."""
    for arch in WIDTHS:
        _load_torch_matches_jax(tmp_path / arch, arch, monkeypatch)


def _load_torch_matches_jax(tmp_path, arch, monkeypatch):
    tmp_path.mkdir()
    jcfg = _openai_files(tmp_path, arch)
    rng = np.random.default_rng(0)
    res = jcfg.image_resolution
    images = {"float": rng.standard_normal((3, res, res, 3)).astype(np.float32),
              "uint8": rng.integers(0, 256, (3, res, res, 3), dtype=np.uint8)}
    tokens = np.zeros((4, 16), np.int32)
    tokens[:, 0] = jcfg.vocab_size - 2
    tokens[:, 1:6] = rng.integers(1, 400, (4, 5))
    tokens[np.arange(4), [6, 8, 12, 15]] = jcfg.vocab_size - 1
    hier = synthetic_hierarchy(2, 2, 0, 0)
    for name in ("plain.pt", "archive.pt"):
        path = str(tmp_path / name)
        cfg, sd = convert.load_torch_checkpoint(path)
        want_cfg, _ = jconvert.load_torch_checkpoint(path)
        port = dataclasses.asdict(cfg)  # JAX's fields, then the port's beyond them at their defaults
        assert {k: port.pop(k) for k in dataclasses.asdict(jcfg)} == \
            dataclasses.asdict(want_cfg) == dataclasses.asdict(jcfg)
        assert port == {k: getattr(tclip.CLIPConfig(), k) for k in port}
        assert not any("num_batches_tracked" in k for k in sd)
        tm = TreeModel.build(Config(arch=arch, dtype="float32"), hier, device="cpu")
        tm.load_torch(path)
        jtm = JTreeModel.build(JConfig(arch=arch, dtype="float32"), hier)
        jtm.load_torch(path)
        assert tm.clip_cfg == cfg
        with torch.inference_mode():
            for x in images.values():
                got = tclip.encode_image(tm.model, torch.from_numpy(x), dtype=torch.float32)
                want = jclip.encode_image(jtm.params, jtm.clip_cfg, jnp.asarray(x),
                                          dtype=jnp.float32)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
            got = tclip.encode_text(tm.model, torch.from_numpy(tokens).long(), dtype=torch.float32)
        want = jclip.encode_text(jtm.params, jtm.clip_cfg, jnp.asarray(tokens), dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        # the zoo: the same weights, and the sha256 check as JAX does it
        zcfg, model = zoo.load(arch, checkpoint=path, device="cpu")
        assert zcfg == cfg and torch.equal(model.state_dict()["logit_scale"], sd["logit_scale"])
        assert zoo.verify_checkpoint(path, "RN50") is jzoo.verify_checkpoint(path, "RN50") is False
        with pytest.raises(ValueError, match="sha256"):
            zoo.load("RN50", checkpoint=path, verify=True, device="cpu")
        digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
        monkeypatch.setitem(zoo.OFFICIAL_SHA256, "RN50", digest)
        monkeypatch.setitem(jzoo.OFFICIAL_SHA256, "RN50", digest)
        assert zoo.verify_checkpoint(path, "RN50") is jzoo.verify_checkpoint(path, "RN50") is True
    # the whole JAX zoo is ported; the port's further names, ViT-L/14,
    # EVA02-CLIP-L/14 and SigLIP-SO400M/14@384, have no digest
    assert zoo.available_models() == jzoo.available_models() + [
        "ViT-L/14", "EVA02-CLIP-L/14", "SigLIP-SO400M/14@384"]
    assert zoo.OFFICIAL_SHA256 == jzoo.OFFICIAL_SHA256
    rcfg, model = zoo.load(arch, seed=1, device="cpu")
    assert rcfg == tclip.get_config(arch) and not model.training


# ---- the real-data cycle ---------------------------------------------------


def _write_jpeg(path, seed, px=48):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = np.kron(rng.standard_normal((6, 6, 3)), np.ones((px // 6, px // 6, 1)))
    img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
    Image.fromarray(img).save(path, quality=90)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``tests/test_e2e_realdata.py``'s tree: 2 top classes, 6 mid, 6 leaves
    (one with two parents); 5 train images per seen class, 3 test images per
    unseen class plus a corrupt file."""
    root = tmp_path_factory.mktemp("realdata")
    data_dir, img_root = root / "process_results", root / "images"
    data_dir.mkdir()
    img_root.mkdir()
    edges, mids, leaves = [("fall11", "a"), ("fall11", "b")], [], []
    for top in ("a", "b"):
        for i in range(3):
            mid = f"{top}{i}"
            mids.append(mid)
            leaves.append(mid + "x")
            edges += [(top, mid), (mid, mid + "x")]
    edges.append(("a0", "b0x"))
    (data_dir / "graph_edges_cls.json").write_text(json.dumps(edges))
    seen = ["a", "b"] + mids
    (data_dir / "splits_for_tree.json").write_text(
        json.dumps({"train": seen, "rest": leaves, "all": seen + leaves}))
    names = {w: f"{w} thing" for w in seen + leaves}
    (data_dir / "names.json").write_text(json.dumps(names))
    manifests, n = {"train": {}, "zsl_test": {}}, 0
    for split, classes, per in (("train", seen, 5), ("zsl_test", leaves, 3)):
        for cls in classes:
            (img_root / cls).mkdir(exist_ok=True)
            manifests[split][cls] = []
            for j in range(per):
                _write_jpeg(str(img_root / cls / f"{j}.jpg"), seed=n)
                manifests[split][cls].append(f"{cls}/{j}.jpg")
                n += 1
    (img_root / leaves[0] / "bad.jpg").write_bytes(b"definitely not a jpeg")
    manifests["zsl_test"][leaves[0]].append(f"{leaves[0]}/bad.jpg")
    for split, m in manifests.items():
        (data_dir / f"{split}_split.json").write_text(json.dumps(m))
    build_index(str(data_dir / "train_split.json"), str(data_dir / "train_split.idx"))
    return root, data_dir, img_root


def _args(ds, folder, *extra):
    root, data_dir, img_root = ds
    return [
        "--arch", "TEST-RN", "--dtype", "float32", "--remat", "False", "--mesh_data", "1",
        "--graph_path", str(data_dir / "graph_edges_cls.json"),
        "--split_path", str(data_dir / "splits_for_tree.json"),
        "--names_path", str(data_dir / "names.json"),
        "--image_root", str(img_root),
        "--vocab_path", str(root / "no_such_vocab.gz"),  # TEST-RN's 512 ids: synthetic tokens
        "--folder", str(folder), "--num_workers", "2", "--batch_size", "2",
        "--test_batch_size", "4", "--num_compare", "4", "--lr", "1e-3", "--print_freq", "1",
        *extra,
    ]


def _records(folder, exp="HGR", event="eval"):
    path = os.path.join(folder, exp, "adaptive_0.25_0.5", "metrics.jsonl")
    recs = [json.loads(line) for line in open(path)]
    if event == "eval":
        return [r for r in recs if r["event"] == "eval" and r["tag"] == "final"][-1]
    return [r["loss"] for r in recs if r["event"] == "train"]


def _port_ckpt(path, clip_params, layer_weight, cfg):
    """JAX params written as a port checkpoint directory (``state.pt``)."""
    os.makedirs(path, exist_ok=True)
    sd = from_jax_params(jax.tree.map(np.asarray, clip_params), cfg)
    torch.save({"params": {"clip": sd, "layer_weight": torch.from_numpy(
        np.array(layer_weight, np.float32))}}, os.path.join(path, "state.pt"))
    return path


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """JAX trains one epoch, tests its clip_0 over the files online, through
    a decode cache and with --k_shots; JAX's initial and trained weights are
    carried into port checkpoints."""
    out = tmp_path_factory.mktemp("runs")
    cwd = os.getcwd()
    os.chdir(out)  # {weights}.txt lands in the working directory
    try:
        jfolder = out / "jax"
        train = ["--epochs", "1", "--n_episodes", "3"]
        jcfg = JConfig.from_args(_args(dataset, jfolder, *train))
        hier, splits = jdriver.build_hierarchy(jcfg)
        jinit = jdriver.build_model(jcfg, hier, splits)
        cfg = tclip.get_config("TEST-RN")
        init = _port_ckpt(str(out / "init"), jinit.params, jinit.layer_weight, cfg)
        jdriver.main(_args(dataset, jfolder, *train))
        jckpt = str(jfolder / "HGR" / "adaptive_0.25_0.5" / "clip_0")
        load = ["--train", "False", "--load", "True", "--load_path", jckpt]
        jdriver.main(_args(dataset, jfolder, *load, "--exp_name", "T"))
        jdriver.main(_args(dataset, jfolder, *load, "--exp_name", "C",
                           "--decode_cache", str(out / "jcache")))
        jdriver.main(_args(dataset, jfolder, *load, "--exp_name", "K", "--k_shots", "2"))
        restored = j_restore_params(jckpt)
        carried = _port_ckpt(str(out / "carried"), restored["clip"], restored["layer_weight"], cfg)
    finally:
        os.chdir(cwd)
    return dict(out=out, jfolder=str(jfolder), init=init, carried=carried, jckpt=jckpt,
                train=train, load=["--train", "False", "--load", "True", "--load_path", carried])


@pytest.fixture
def live_pools(monkeypatch):
    """One entry per decode-process pool a loader or the cache build makes:
    whether all its workers were running when it was made."""
    from hgr_tpu_torch.data import pipeline

    made, real = [], pipeline._maybe_mp_pool

    def spy(source, num_procs, batch_size):
        pool = real(source, num_procs, batch_size)
        if pool is not None:
            made.append(all(p.is_alive() for p in pool._procs))
        return pool

    monkeypatch.setattr(pipeline, "_maybe_mp_pool", spy)
    return made


def _same_metrics(got, want):
    for k in COUNTS:
        assert got[k] == want[k], k
    for k in RATIOS:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_e2e_file_cycle_matches_jax(dataset, runs, tmp_path, monkeypatch, capsys, live_pools):
    monkeypatch.chdir(tmp_path)
    folder = tmp_path / "port"
    procs = ("--num_proc_workers", "2")
    # train from JAX's initial weights (--fetch) over the mmap-indexed
    # manifest, the files decoded by 2 processes (JAX's run: threads)
    driver.main(_args(dataset, folder, *runs["train"], "--fetch", "True",
                      "--fetch_path", runs["init"], *procs), device="cpu")
    assert live_pools == [True]
    assert "no BPE merges file" in capsys.readouterr().out
    got, want = _records(folder, event="train"), _records(runs["jfolder"], event="train")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the port tests its own clip_0 (--load --from_epoch) over the files
    driver.main(_args(dataset, folder, "--train", "False", "--load", "True",
                      "--from_epoch", "0"), device="cpu")
    own = _records(folder)
    assert own["num_samples"] == 6 * 3 + 1  # the corrupt file counts, as its class's first image
    assert all(np.isfinite(v) for v in own.values() if isinstance(v, float))
    # JAX's trained weights carried across: JAX's counts over the files, by
    # threads and by 2 decode processes
    driver.main(_args(dataset, folder, *runs["load"], "--exp_name", "T"), device="cpu")
    driver.main(_args(dataset, folder, *runs["load"], "--exp_name", "P", *procs), device="cpu")
    assert live_pools == [True, True]
    _same_metrics(_records(folder, "T"), _records(runs["jfolder"], "T"))
    _same_metrics(_records(folder, "P"), _records(folder, "T"))
    _same_metrics(_records(folder, "P"), _records(runs["jfolder"], "T"))
    # flat fine-tuning over the files: the processes give the threads' losses
    flat = ("--training_method", "flat", "--epochs", "1", "--fetch", "True",
            "--fetch_path", runs["init"])
    driver.main(_args(dataset, folder, *flat, "--exp_name", "F1"), device="cpu")
    driver.main(_args(dataset, folder, *flat, "--exp_name", "F2", *procs), device="cpu")
    assert live_pools == [True, True, True]
    got, want = _records(folder, "F2", event="train"), _records(folder, "F1", event="train")
    assert len(got) == len(want) == 20 and got == want


def test_cached_and_kshot_runs_match_jax(dataset, runs, tmp_path, monkeypatch, live_pools):
    """--decode_cache builds the split's cache (byte for byte JAX's) by 2
    decode processes, then replays it; both runs and --k_shots give JAX's
    counts."""
    monkeypatch.chdir(tmp_path)
    folder, cache = tmp_path / "port", tmp_path / "cache"
    for exp in ("C1", "C2"):
        driver.main(_args(dataset, folder, *runs["load"], "--exp_name", exp,
                          "--decode_cache", str(cache), "--num_proc_workers", "2"), device="cpu")
        _same_metrics(_records(folder, exp), _records(runs["jfolder"], "C"))
    assert live_pools == [True]  # the build's; the loaders read the cache
    _same_metrics(_records(folder, "C2"), _records(runs["jfolder"], "T"))
    for f in ("images.u8", "class_ptr.npy", "offsets.npy", "paths.bin", "meta.json"):
        a = (cache / "zsl_test" / f).read_bytes()
        assert a == (runs["out"] / "jcache" / "zsl_test" / f).read_bytes(), f
    driver.main(_args(dataset, folder, *runs["load"], "--exp_name", "K", "--k_shots", "2"),
                device="cpu")
    got = _records(folder, "K")
    _same_metrics(got, _records(runs["jfolder"], "K"))
    assert got["num_samples"] == 6 * 2


def test_classify_files_and_serve_cli_match_jax(dataset, runs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, _, img_root = dataset
    files = [str(p) for p in sorted(FIXTURES.iterdir())
             if p.suffix in (".jpg", ".png") and p.name != "corrupt.jpg"]
    files += [str(img_root / "a0x" / "1.jpg")]
    cfg = Config.from_args(_args(dataset, tmp_path / "p", *runs["load"]))
    jcfg = JConfig.from_args(_args(dataset, tmp_path / "j", "--train", "False", "--load",
                                   "True", "--load_path", runs["jckpt"]))
    hier, splits = driver.build_hierarchy(cfg)
    tm = driver.build_model(cfg, hier, splits, device="cpu")
    jtm = jdriver.build_model(jcfg, *jdriver.build_hierarchy(jcfg))
    for candidates in ("all", "test"):
        got = serve.ZeroShotClassifier(tm, candidates).classify_files(files, k=5, batch=3,
                                                                       num_threads=2)
        want = jserve.ZeroShotClassifier(jtm, candidates).classify_files(files, k=5, batch=3,
                                                                         num_threads=2)
        assert [[w for w, _ in r] for r in got] == [[w for w, _ in r] for r in want]
        np.testing.assert_allclose([[s for _, s in r] for r in got],
                                   [[s for _, s in r] for r in want], atol=1e-4)
    with pytest.raises(Exception):
        serve.ZeroShotClassifier(tm).classify_files([str(FIXTURES / "corrupt.jpg")])

    def lines(main, argv, **kw):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(argv, **kw)
        return [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith('{"image"')]

    three = [os.path.basename(f) for f in files[:3]]
    # the serving --image_root comes last, so it wins over the dataset's
    tail = ["--k", "3", "--candidates", "test", "--image_root", str(FIXTURES)]
    got = lines(serve.main, three + _args(dataset, tmp_path / "p", *runs["load"]) + tail,
                device="cpu")
    want = lines(jserve.main, three + _args(dataset, tmp_path / "j", "--train", "False", "--load",
                                            "True", "--load_path", runs["jckpt"]) + tail)
    assert [g["image"] for g in got] == [w["image"] for w in want] == three
    for g, w in zip(got, want):
        assert [t["wnid"] for t in g["topk"]] == [t["wnid"] for t in w["topk"]]
        assert [t["name"] for t in g["topk"]] == [t["wnid"] + " thing" for t in g["topk"]]
        np.testing.assert_allclose([t["score"] for t in g["topk"]],
                                   [t["score"] for t in w["topk"]], atol=1.5e-4)
