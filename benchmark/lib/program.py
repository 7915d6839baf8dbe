"""What the entries take from the program under test,
``sdfgenfast_tpu_torch``: its configuration object built from a
configuration file, its grid and mesh types, and the card's name."""

from __future__ import annotations

import subprocess


def sdf_config(fields: dict):
    """``pipeline.SDFConfig`` with the file's fields (lists as tuples)."""
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    return SDFConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})


def card_line(index: int = 0) -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note that
    it was not read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "power limit not read"
