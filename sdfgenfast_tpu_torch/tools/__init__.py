"""Measurement tools of the port, each run as ``python3 -m
sdfgenfast_tpu_torch.tools.<name>`` on a card: ``micro_bench`` (the probes
P1-P4 of the card's ceilings), ``bench`` (bench.py's seven configurations
and its JSON line), ``profile_stages`` (the default path's stages, read from
the production call's spans), ``batch_bench`` (``generate_sdf_batch``
against one mesh at a time), ``stress_256`` (repeated calls in one process
and the memory they hold), ``kernel_bench`` (the dense path's stages queued
back to back) and ``scaling_bench`` (the sharded path on 1, 2, 4 shards or
cards). ``timing`` holds what they share."""
