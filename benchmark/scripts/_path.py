"""Put the benchmark and the checkout on ``sys.path``, as ``run.py`` does."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [BENCH, ROOT]
