"""The least bytes kernel K3 (``vdt_round_kernel``) moves in one call of
the program's default binned path, counted from the grid's shape.

Frozen copy of the schedule arithmetic of ``chip_smoke.pyramid_rounds``
and ``sdfgenfast_tpu_torch/ops/vdt.py`` (``pyramid_level_shapes``,
``stride_ladder``, the rounds a level) and of the pipeline's axis
permutation (``pipeline._vdt_axis_perm``): a change to the program's
schedule does not move the yardstick. A round reads each cell's 20-byte
state once and writes it once: 40 bytes a cell a round.
"""

from __future__ import annotations

import itertools

import numpy as np

COARSE_MAX = 48
MAX_LEVELS = 3
LEVEL_ROUNDS = 5          # (8, 4, 2, 2, 1) on the finest level
COARSE_ROUNDS = 5         # (8, 4, 2, 1, 1) on each level between
EXTRA_POLISH = 2          # stride-1 rounds after the finest level's
BYTES_PER_CELL_ROUND = 40


def axis_perm(shape):
    """The pipeline's axis order for the pyramid (the least padded cells
    with the last axis padded to 128; the first such order wins)."""
    best = (0, 1, 2)

    def padded(p):
        d = [shape[p[0]], shape[p[1]], shape[p[2]]]
        return d[0] * d[1] * (-(-d[2] // 128) * 128)

    for p in itertools.permutations((0, 1, 2)):
        if padded(p) < padded(best):
            best = p
    return best


def level_shapes(shape):
    shapes = [tuple(shape)]
    while max(shapes[-1]) > COARSE_MAX and len(shapes) < MAX_LEVELS:
        shapes.append(tuple(-(-d // 2) for d in shapes[-1]))
    return shapes


def ladder_rounds(max_dim: int, extra_rounds: int = 1) -> int:
    """Rounds of the jump-flood ladder max_dim/2, ..., 1 plus extras."""
    s, n = 1, 0
    while s * 2 < max_dim:
        s *= 2
    while s >= 1:
        n += 1
        s //= 2
    return n + extra_rounds


def rounds(shape):
    """[(level shape, rounds on it)] of one call, coarsest first."""
    perm = axis_perm(shape)
    shapes = level_shapes(tuple(shape[p] for p in perm))
    out = [(shapes[-1], ladder_rounds(max(shapes[-1])))]
    if len(shapes) == 1:
        return out
    for lvl in range(len(shapes) - 2, 0, -1):
        out.append((shapes[lvl], COARSE_ROUNDS))
    out.append((shapes[0], LEVEL_ROUNDS + EXTRA_POLISH))
    return out


def k3_bytes(shape) -> int:
    """The least bytes K3 reads and writes in one call on `shape`."""
    return sum(int(np.prod(s)) * n * BYTES_PER_CELL_ROUND
               for s, n in rounds(shape))
