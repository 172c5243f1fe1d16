"""The port's decode processes (``hgr_tpu_torch/data/mp_decode.py``) against
its thread path and the JAX package's pool, on the committed fixtures
(``tests/torch_fixtures``: odd sizes, grayscale, CMYK, a PNG with alpha and
a corrupt JPEG). Rows are uint8 and compared exactly.

- the pool: rows equal to ``FileImageSource.load`` and to JAX's
  ``ProcessDecodePool``, the corrupt file as its class's first image, pairs
  mode and the CPU accounting;
- faults: a worker error is raised once every ack is in (the pool is then
  sound), an ack timeout poisons the pool;
- processes: a worker whose parent dies exits on its own, and a worker
  started from a main script that imports torch does not load torch;
- the three loaders with ``num_procs=2`` give the thread path's batches.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hgr_tpu.data.mp_decode import ProcessDecodePool as JPool  # noqa: E402
from hgr_tpu_torch.data import pipeline  # noqa: E402
from hgr_tpu_torch.data.mp_decode import ProcessDecodePool  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
GOOD = sorted(p.name for p in FIXTURES.iterdir()
              if p.suffix in (".jpg", ".png") and p.name != "corrupt.jpg")
REPO = Path(__file__).resolve().parent.parent


def test_pool_rows_match_threads_and_jax():
    paths = GOOD + ["corrupt.jpg"]
    idxs = list(range(len(paths)))
    src = pipeline.FileImageSource(32, str(FIXTURES))
    want = np.stack([src.load("c", paths, i) for i in idxs])
    with ProcessDecodePool(32, batch_size=8, image_root=str(FIXTURES), num_workers=2) as pool, \
            JPool(32, batch_size=8, image_root=str(FIXTURES), num_workers=2) as jpool:
        got = pool.decode("c", paths, idxs)
        assert got.dtype == np.uint8 and got.shape == (len(paths), 32, 32, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jpool.decode("c", paths, idxs))
        np.testing.assert_array_equal(got[-1], got[0])  # corrupt -> the class's first
        assert pool.images_decoded == len(paths) and pool.cpu_s_per_image > 0
        # pairs mode: rows of several classes, each with its own fallback
        pairs = [(GOOD[2], GOOD[0]), ("corrupt.jpg", GOOD[3]), (GOOD[1], GOOD[1])]
        rows = pool.decode_pairs(pairs)
        np.testing.assert_array_equal(rows, jpool.decode_pairs(pairs))
        np.testing.assert_array_equal(rows[1], src.load("c", [GOOD[3]], 0))
        assert pool.decode_pairs([]).shape == (0, 32, 32, 3)
        with pytest.raises(ValueError, match="capacity"):
            pool.decode_pairs(pairs * 3)


def test_pool_faults_drain_and_poison():
    """A slice that fails (neither its path nor its fallback decodes) raises
    once every worker's ack is in, so the next batch is decoded afresh; an
    ack timeout leaves acks in flight and poisons the pool."""
    src = pipeline.FileImageSource(32, str(FIXTURES))
    with ProcessDecodePool(32, batch_size=4, image_root=str(FIXTURES), num_workers=2) as pool:
        with pytest.raises(RuntimeError, match="decode worker failed"):
            pool.decode_pairs([("none.jpg", "other.jpg"), (GOOD[2], GOOD[0])])
        idxs = [3, 1, 4]
        np.testing.assert_array_equal(pool.decode("c", GOOD, idxs),
                                      np.stack([src.load("c", GOOD, i) for i in idxs]))
        assert pool.images_decoded == 1 + len(idxs)  # the failed batch's other slice counts
    # workers take far more than 1 ms to start: the first ack times out
    pool = ProcessDecodePool(32, batch_size=4, image_root=str(FIXTURES), num_workers=1,
                             timeout_s=0.001)
    try:
        with pytest.raises(RuntimeError, match="timed out"):
            pool.decode("c", GOOD, [0])
        with pytest.raises(RuntimeError, match="unusable"):
            pool.decode("c", GOOD, [0])
    finally:
        pool.close()


def test_workers_exit_orphaned_and_load_no_torch(tmp_path):
    """A main script that imports torch starts a pool, has one batch
    decoded, reads whether torch's libraries are mapped into its worker
    (``/proc/<pid>/maps``), and exits hard (no close(), no atexit); the
    worker notices its parent is gone and exits."""
    script = tmp_path / "main.py"
    script.write_text(f"""
import os, sys
import torch  # the parent holds torch; its worker must not
sys.path.insert(0, {str(REPO)!r})
from hgr_tpu_torch.data.mp_decode import ProcessDecodePool
pool = ProcessDecodePool(32, batch_size=2, image_root={str(FIXTURES)!r}, num_workers=1,
                         orphan_poll_s=0.5)
pool.decode("c", {GOOD!r}, [0, 1])
pid = pool._procs[0].pid
maps = open(f"/proc/{{pid}}/maps").read()
mine = open("/proc/self/maps").read()
print(pid, "/torch/" in maps, "/torch/" in mine, flush=True)
os._exit(0)
""")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    pid, worker_torch, parent_torch = out.stdout.strip().splitlines()[-1].split()
    assert (worker_torch, parent_torch) == ("False", "True"), out.stdout
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            os.kill(int(pid), 0)
        except ProcessLookupError:
            return
        time.sleep(0.2)
    raise AssertionError(f"orphaned decode worker {pid} still alive")


def test_loaders_with_processes_match_threads():
    grouped = {"a": GOOD[:3] + ["corrupt.jpg"], "b": GOOD[3:], "c": [GOOD[0]] * 3}
    ids = {c: i for i, c in enumerate(grouped)}
    src = pipeline.FileImageSource(32, str(FIXTURES))
    loaders = [
        (pipeline.GroupedTestLoader, dict(batch_size=3)),
        (pipeline.GroupedTrainLoader, dict(batch_size=3, n_episodes=5, seed=11)),
        (pipeline.FlatTrainLoader, dict(batch_size=3, seed=7, drop_last=False)),
    ]
    for cls, kw in loaders:
        threads = cls(grouped, ids, src, num_threads=2, **kw)
        procs = cls(grouped, ids, src, num_threads=2, num_procs=2, **kw)
        assert threads.mp_pool is None and procs.mp_pool is not None
        try:
            got, want = list(procs), list(threads)
        finally:
            threads.close()
            procs.close()
        assert len(got) == len(want) > 0, cls.__name__
        for g, w in zip(got, want):
            if isinstance(w, tuple):  # the flat loader's (images, labels, valid)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            else:
                assert g.target == w.target and g.paths == w.paths
                np.testing.assert_array_equal(g.valid, w.valid)
                np.testing.assert_array_equal(g.images, w.images)
    # processes apply to files only: a synthetic source keeps threads
    syn = pipeline.GroupedTestLoader(grouped, ids, pipeline.SyntheticImageSource(8), 3,
                                     num_procs=2)
    assert syn.mp_pool is None
    syn.close()
