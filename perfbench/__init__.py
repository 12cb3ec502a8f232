"""The benchmark of ``sushi_tpu_torch`` on one NVIDIA card (``run.py``)."""
