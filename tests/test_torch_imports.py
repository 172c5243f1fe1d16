"""The PyTorch port stands alone: no JAX and nothing of ``hgr_tpu``.

An AST scan of every module of ``hgr_tpu_torch`` (the baselines included),
of ``chip_smoke.py`` and of the port's tools (``tools/*torch*.py``), the
mesh (``parallel/*``, ``train/spmd.py``), the offline builders and the Orbax
reader (``utils/{zstd,ocdbt,zarr,orbax}.py``) included, finds no import of
``jax`` (or ``jaxlib``, ``optax``, ``orbax``, ``tensorstore``, ``zstandard``:
the reader is the port's own), of ``networkx`` or ``regex`` (the port has
its own chain search and word splitter), none of ``hgr_tpu`` other than
``hgr_tpu_torch``, and not the root ``bench.py``; importing the package in a
fresh interpreter leaves them all out of ``sys.modules``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "tensorstore", "zstandard", "hgr_tpu",
             "networkx", "regex", "bench")
FILES = (sorted((REPO / "hgr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
         + sorted((REPO / "tools").glob("*torch*.py")))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_or_reference_imports():
    """One scan over every file; the failure names each offender."""
    bad = {}
    for path in FILES:
        mods = [m for m in _imported(ast.parse(path.read_text(), str(path)))
                if m.split(".")[0] in FORBIDDEN]
        if mods:
            bad[str(path.relative_to(REPO))] = mods
    assert len(FILES) > 30 and REPO / "chip_smoke.py" in FILES
    assert {"run.py", "gcn.py", "free.py", "cnzsl.py"} <= {
        p.name for p in FILES if p.parent.name == "baselines"}
    assert {"mesh.py", "distributed.py", "collectives.py", "eval_spmd.py"} <= {
        p.name for p in FILES if p.parent.name == "parallel"}
    assert {"spmd.py", "builder.py", "splits.py"} <= {p.name for p in FILES}
    assert {"zstd.py", "ocdbt.py", "zarr.py", "orbax.py"} <= {
        p.name for p in FILES if p.parent.name == "utils"}
    assert not bad, f"imports of JAX or the JAX package: {bad}"


def test_package_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import hgr_tpu_torch, hgr_tpu_torch.driver, hgr_tpu_torch.tree_model\n"
        "import hgr_tpu_torch.__main__, hgr_tpu_torch.serve, hgr_tpu_torch.train\n"
        "import hgr_tpu_torch.utils.checkpoint, hgr_tpu_torch.utils.preempt\n"
        "import hgr_tpu_torch.text, hgr_tpu_torch.models.zoo, hgr_tpu_torch.data.native\n"
        "import hgr_tpu_torch.data.decode_cache, hgr_tpu_torch.data.manifest_index\n"
        "import hgr_tpu_torch.baselines, hgr_tpu_torch.baselines.run\n"
        "import hgr_tpu_torch.baselines.materials, hgr_tpu_torch.baselines.features\n"
        "import hgr_tpu_torch.models.coop, hgr_tpu_torch.models.resnet_std\n"
        "import hgr_tpu_torch.data.mp_decode, hgr_tpu_torch.baselines.refit\n"
        "import hgr_tpu_torch.utils.profiling\n"
        "import hgr_tpu_torch.parallel, hgr_tpu_torch.parallel.mesh\n"
        "import hgr_tpu_torch.parallel.distributed, hgr_tpu_torch.parallel.collectives\n"
        "import hgr_tpu_torch.parallel.eval_spmd, hgr_tpu_torch.train.spmd\n"
        "import hgr_tpu_torch.hierarchy.builder, hgr_tpu_torch.data.splits\n"
        "import hgr_tpu_torch.utils.orbax, hgr_tpu_torch.utils.zarr\n"
        "from hgr_tpu_torch.hierarchy import synthetic_hierarchy\n"
        "from hgr_tpu_torch.text import Tokenizer\n"
        "synthetic_hierarchy(3, 3, 4, 0)\n"
        "Tokenizer(merges=[('a', 'b')]).encode('ab 12 x')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"
