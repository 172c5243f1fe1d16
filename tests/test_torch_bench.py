"""The port's benchmark (``hgr_tpu_torch/bench.py``, ``python -m
hgr_tpu_torch.bench``) against the JAX package's ``bench.py``, on the CPU:
the same work under the same names. One test, five checks:

1. setup: at TEST-RN the port's tables are ``bench._setup``'s (node count,
   18,432 rows, depth order and level offsets, tokens, the target);
2. eval's workload: the bank (bf16 bits), the uint8 images and the target
   are the draws of ``bench.py:138-151``; with JAX's weights carried across
   by ``from_jax_params``, one ``eval_step_sorted`` at batch 8 in fp32 gives
   JAX's counts exactly, path and point within 1e-6 relative, and logits
   within 1e-5 of the largest (fp32 with other summation orders);
3. train's workload: the targets, the device schedules and the image
   microbatches at ``accum=2``, with and without CoOp, are
   ``bench.py:386-440``'s;
4. the line: for the same results ``_emit`` prints ``bench._emit``'s line
   plus ``extra["device"]`` (``host_cores_to_feed_chip``, ``status``
   ``"missing"`` without eval);
5. refusals: without CUDA ``main`` and ``python -m hgr_tpu_torch.bench``
   raise and print no ``"status"``; a section that raises ends the run
   non-zero after its traceback and the last ``#partial`` line; none of
   ``bench.py``'s watchdog, sidecar or stale fallback exists in the port.

JAX's weights come from its ``clip_init`` under ``jax.jit`` (one compile in
place of an eager draw per leaf); the tables do not depend on them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
from hgr_tpu import tree_model as jtree_model  # noqa: E402
from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.eval.bank import bank_logits as j_bank_logits  # noqa: E402
from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.train import NegativeSampler as JSampler  # noqa: E402
from hgr_tpu.train import ScheduleBuilder as JBuilder  # noqa: E402
from hgr_tpu.train import sched_to_device as j_sched_to_device  # noqa: E402
from hgr_tpu_torch import bench as pbench  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.eval.bank import bank_logits  # noqa: E402
from hgr_tpu_torch.models.clip import encode_image  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_BATCH = 8
LOGITS_REL = 1e-5
STAMP = {"name": "card", "power_limit": "1.00 W", "count": 1}


def _check_setup(jax_setup, port_setup):
    (jhier, jtm), (hier, tm) = jax_setup, port_setup
    assert hier.num_nodes == jhier.num_nodes and hier.names == jhier.names
    assert tm.n_pad == jtm.n_pad == pbench.N_CLASSES_PAD == bench.N_CLASSES_PAD
    assert tm.level_offsets == tuple(jtm.level_offsets)
    for f in ("depth_order", "node_depth", "node_tokens", "chains", "chain_len"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jtm, f), err_msg=f)
    assert hier.max_depth == jhier.max_depth
    assert int(hier.level(hier.max_depth)[0]) == int(jhier.level(jhier.max_depth)[0])


def _jax_eval_inputs(jtm, jhier, batch):
    """``bench.py:138-151`` as it stands."""
    rng = np.random.default_rng(0)
    bank = jnp.asarray(
        rng.standard_normal((jtm.n_pad, jtm.clip_cfg.embed_dim)).astype(np.float32),
        jnp.bfloat16)
    res = jtm.clip_cfg.image_resolution
    images = jnp.asarray(rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8))
    return jtm.sort_bank(bank), images, int(jhier.level(jhier.max_depth)[0])


def _check_eval(jax_setup, port_setup):
    (jhier, jtm), (hier, tm) = jax_setup, port_setup
    jtm32 = jtree_model.TreeModel.build(JConfig(arch="TEST-RN", dtype="float32"), jhier,
                                        pad_multiple=bench.N_CLASSES_PAD)
    tm32 = TreeModel.build(Config(arch="TEST-RN", dtype="float32"), hier,
                           pad_multiple=pbench.N_CLASSES_PAD, device="cpu")
    tm32.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtm.params), tm32.clip_cfg))
    jbank, jimages, jtarget = _jax_eval_inputs(jtm32, jhier, EVAL_BATCH)
    bank, images, target = pbench.eval_inputs(tm32, hier, EVAL_BATCH)
    assert target == jtarget and bank.dtype == torch.bfloat16 and images.dtype == torch.uint8
    np.testing.assert_array_equal(bank.view(torch.int16).numpy(),
                                  np.asarray(jbank).view(np.int16))
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))

    want = jtm32.eval_step_sorted(jtm.params, jbank, jimages, jtarget)
    got = tm32.eval_step_sorted(bank, images, target)
    np.testing.assert_array_equal(got.hits.numpy(), np.asarray(want.hits))
    for f in ("tor", "num"):
        assert float(getattr(got, f)) == float(getattr(want, f)), f
    for f in ("path", "point"):
        assert float(getattr(got, f)) == pytest.approx(float(getattr(want, f)), rel=1e-6), f
    jlogits = np.asarray(jax.jit(lambda p, x, b: j_bank_logits(jtm32.encode_image_fn(p, x), b))(
        jtm.params, jimages, jbank))
    with torch.inference_mode():
        logits = bank_logits(encode_image(tm32.model, images, dtype=torch.float32), bank).numpy()
    err = np.abs(logits - jlogits).max()
    assert err <= LOGITS_REL * np.abs(jlogits).max(), err


def _check_train(jax_setup, port_setup, coop):
    """The targets, schedules and images of ``_train_rate(batch, coop=coop,
    accum=2)``, made as ``bench.py:386-440`` makes them."""
    (jhier, jtm), (hier, tm) = jax_setup, port_setup
    batch, accum = 16, 2
    jcfg = JConfig(arch="RN50", num_compare=256, batch_size=batch // accum, remat=True,
                   coop=coop, accum_steps=accum)
    rng = np.random.default_rng(0)
    res = jtm.clip_cfg.image_resolution
    deep_level = jhier.level(jhier.max_depth)
    jtargets = [int(deep_level[k % len(deep_level)]) for k in range(accum)]
    sampler = JSampler(jhier, np.arange(jhier.num_nodes), jcfg.num_compare, seed=0,
                       topk_window="both" if coop else "below")
    builder = JBuilder(jhier, sampler, jcfg.out_ratio, jcfg.in_ratio, jcfg.num_compare)
    jscheds = [j_sched_to_device(builder.build(t)) for t in jtargets]
    jimages = [rng.integers(0, 256, (batch // accum, res, res, 3), dtype=np.uint8)
               for _ in range(accum)]

    tcfg = pbench.train_config("TEST-RN", batch, coop=coop, accum=accum)
    assert (tcfg.batch_size, tcfg.num_compare, tcfg.accum_steps, tcfg.remat, tcfg.coop) == (
        jcfg.batch_size, jcfg.num_compare, jcfg.accum_steps, jcfg.remat, jcfg.coop)
    targets, scheds, images = pbench.train_inputs(tm, hier, tcfg)
    assert targets == jtargets and len(targets) == len(set(targets)) == accum
    for got, want in zip(scheds, jscheds):
        assert set(got) == set(want) - {"compare"}  # the port's loss never reads it
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for got, want in zip(images, jimages):
        np.testing.assert_array_equal(got.numpy(), want)


def _lines(capsys, emit, out):
    emit(dict(out))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _check_line(capsys):
    full = {"calib_tflops": 700.1, "calib_dispatch_ms": 0.02, "eval_imgs_per_sec": 6900.0,
            "vit_b32_eval_imgs_per_sec": 7000.0, "decode_cpu_ms_per_img": 1.5,
            "loader_imgs_per_sec": 800.0, "train_step_ms": 340.0,
            "section_done_s": {"calib": 3.0, "eval": 9.5}}
    for out in (full, {k: v for k, v in full.items() if k != "eval_imgs_per_sec"}, {}):
        want = _lines(capsys, bench._emit, out)
        got = _lines(capsys, lambda o: pbench._emit(o, STAMP), out)
        assert got["extra"].pop("device") == STAMP
        assert got == want
        assert want["status"] == ("ok" if "eval_imgs_per_sec" in out else "missing")
    assert want["value"] == 0.0 and want["metric"] == pbench.METRIC


def _check_refusals(monkeypatch, capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbench.main()
    assert '"status"' not in capsys.readouterr().out
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "hgr_tpu_torch.bench"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "CUDA is not available" in p.stderr
    assert '"status"' not in p.stdout

    def calib(out, device):
        out["calib_tflops"] = 1.0

    def broken(out, device):
        raise ValueError("boom")

    monkeypatch.setattr(pbench, "select_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(pbench, "device_stamp", lambda device: STAMP)
    monkeypatch.setitem(pbench.SECTION_FNS, "calib", calib)
    monkeypatch.setitem(pbench.SECTION_FNS, "eval", broken)
    with pytest.raises(SystemExit) as e:
        pbench.main(["calib", "eval", "vit"])
    assert e.value.code not in (0, None) and "eval" in str(e.value.code)
    cap = capsys.readouterr()
    assert "ValueError: boom" in cap.err and '"status"' not in cap.out
    last = cap.out.strip().splitlines()[-1]
    assert last.startswith("#partial ") and json.loads(last[9:])["calib_tflops"] == 1.0
    with pytest.raises(SystemExit, match="unknown sections"):
        pbench.main(["eval", "nope"])
    source = open(pbench.__file__).read()
    for name in ("_run_with_watchdog", "_child", "_probe_tunnel", "_sidecar_update",
                 "_sidecar_fill", "_parse_partials"):
        assert not hasattr(pbench, name), name
    for name in ("BENCH_SIDECAR", "HGR_BENCH_BUDGET_S", "HGR_BENCH_INNER", "HGR_BENCH_T0"):
        assert name not in source, name


def test_bench_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_SETUP_CACHE", {})
    monkeypatch.setattr(pbench, "_SETUP_CACHE", {})
    monkeypatch.setattr(jtree_model, "clip_init", jax.jit(jclip.clip_init, static_argnums=1))
    jax_setup = bench._setup("TEST-RN")
    port_setup = pbench.setup("TEST-RN", "cpu")
    assert pbench.SECTIONS == bench.SECTIONS and pbench.BATCH == bench.BATCH
    _check_setup(jax_setup, port_setup)
    _check_eval(jax_setup, port_setup)
    for coop in (False, True):
        _check_train(jax_setup, port_setup, coop)
    _check_line(capsys)
    _check_refusals(monkeypatch, capsys)
