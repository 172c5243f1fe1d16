"""What the benchmark may import: no JAX or JAX package anywhere, none of
the program's retired benchmarks, and nothing of the program in the
reference's modules or in a family's file (``families/*.py``). Module names are compared whole, by their part before
the first dot, so ``hgr_tpu_torch`` passes where ``hgr_tpu`` fails."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "hgr_tpu", "bench", "chip_smoke",
             "tools"}
# the yardstick: reference, comparison, inputs, work counts, trace reduction
REFERENCE_SIDE = ["reference.py", "reference_train.py", "check.py", "inputs.py", "work.py",
                  "trace.py", "spec.py", "family.py"]
FAMILIES = sorted((Path(BENCH) / "families").glob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _sources():
    return sorted(p for p in Path(BENCH).rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN or m == "hgr_tpu_torch.bench"]
    assert not bad, bad


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_imports_nothing_of_the_program(name):
    mods = list(_imports(Path(BENCH) / "hbench" / name))
    assert not [m for m in mods if m.split(".")[0] == "hgr_tpu_torch"], mods


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.name)
def test_family_imports_nothing_of_the_program(path):
    """A family imports nothing of the program, and of the harness only the
    reference's side, through which nothing of the program comes either."""
    mods = list(_imports(path))
    assert not [m for m in mods if m.split(".")[0] == "hgr_tpu_torch"], mods
    side = {"hbench"} | {"hbench." + n[: -len(".py")] for n in REFERENCE_SIDE}
    harness = [m for m in mods if m.split(".")[0] == "hbench"]
    assert all(".".join(m.split(".")[:2]) in side for m in harness), harness


def test_forbidden_modules_compares_whole_names():
    from hbench.main import forbidden_modules

    sys.modules.setdefault("hgr_tpu_torch_probe_x", sys)
    try:
        assert "hgr_tpu_torch_probe_x" not in forbidden_modules()
    finally:
        del sys.modules["hgr_tpu_torch_probe_x"]
    sys.modules["hgr_tpu.probe"] = sys
    try:
        assert "hgr_tpu.probe" in forbidden_modules()
    finally:
        del sys.modules["hgr_tpu.probe"]


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh interpreter, leaves no
    forbidden module behind."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from hbench import main, spec, reference, check, work, trace\n"
        "from hbench import reference_train, faults, family\n"
        "from pathlib import Path\n"
        "for p in Path(%r).glob('*.py'): family.load({'family': p.stem}, Path(%r))\n"
        "from hbench.drivers import base, eval, refresh, train\n"
        "import hgr_tpu_torch.train, hgr_tpu_torch.data\n"
        "import hgr_tpu_torch.tree_model, hgr_tpu_torch.config\n"
        "import hgr_tpu_torch.hierarchy, hgr_tpu_torch.models.clip, hgr_tpu_torch.eval.metrics\n"
        "bad = main.forbidden_modules()\n"
        "assert not bad, bad\n" % (BENCH, ROOT, str(Path(BENCH) / "families"), BENCH)
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert r.returncode == 0, r.stderr[-2000:]
