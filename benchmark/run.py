"""The benchmark of hgr_tpu_torch on the H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the run's parts and the numbers it
checked on standard error, and one JSON line last on standard output (see
``benchmark/README.md``).
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's caches live at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from hbench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, time.perf_counter()))
