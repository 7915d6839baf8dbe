"""The benchmark of ``sdfgenfast_tpu_torch`` on NVIDIA cards (``run.py``)."""
