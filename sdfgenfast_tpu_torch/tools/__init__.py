"""Measurement tools of the port, each run as ``python3 -m
sdfgenfast_tpu_torch.tools.<name>`` on a card: ``micro_bench`` (the probes
P1-P4 of the card's ceilings), ``bench`` (bench.py's seven configurations
and its JSON line), ``profile_stages`` (the default path's stages, checked
against the production call) and ``batch_bench`` (``generate_sdf_batch``
against one mesh at a time). ``timing`` holds what they share."""
