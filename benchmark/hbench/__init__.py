"""The benchmark of ``hgr_tpu_torch`` on the H100 (``python3 benchmark/run.py``)."""
