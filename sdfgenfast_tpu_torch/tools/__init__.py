"""Measurement tools of the port. ``micro_bench``: the probes P1-P4 of the
card's ceilings (``python3 -m sdfgenfast_tpu_torch.tools.micro_bench``)."""
