"""K4's fused tiling (``csrc/chamfer.cu``), transcribed in torch on the CPU,
against the chamfer twins.

The transcription computes what each block of ``chamfer_fused_kernel``
computes, with the launches of ``vdt_kernel.chamfer_chunks`` and the
geometry of the kernel's ``Tile<P>`` and ``launch<P>`` (``tiles`` below):
per (j, k) column tile and i-segment, the input window
(the segment's planes with a P-deep warm-up on each side, the column with a
P-deep halo; 3e38 wherever the window leaves the grid), then level L = 1..P
on the window shrunk by one cell per side and level, each offset applied as
``acc = minimum(acc, nb + step)`` in _OFFSETS26 order, and 3e38 stored
again at every window cell outside the grid before the next level reads it.
The last level's cells inside the grid are the output. What it leaves out
is the order in which the kernel visits the planes (its rolling rings),
which moves no value.

Bars: bit-equal to ``vdt.chamfer_relax`` (the port's twin), to the JAX
package's ``chamfer_relax`` and to ``pallas_chamfer(interpret=True)``, which
are bit-equal to each other on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfgenfast_tpu.ops import vdt as JV
from sdfgenfast_tpu.ops.vdt_pallas import pallas_chamfer
from sdfgenfast_tpu_torch.ops import vdt as PV
from sdfgenfast_tpu_torch.ops import vdt_kernel

torch.set_num_threads(1)

DX = np.float32(0.02)
BIG = np.float32(3e38)


def tiles(shape, passes, sms, blocks_per_sm):
    """(tile_j, tile_k, seg) of a K4 launch of `passes` fused passes, as
    csrc/chamfer.cu's Tile<P> and launch<P>: a (j, k) column of tile_j x
    tile_k cells a block, and each column split along i into segments of
    seg planes so that the blocks fill sms x blocks_per_sm slots at most
    (one wave on the card)."""
    ni, nj, nk = shape
    tj, tk = (32 if passes <= 2 else 16), 64
    columns = -(-nj // tj) * -(-nk // tk)
    segments = max(1, sms * blocks_per_sm // columns)
    return tj, tk, -(-ni // segments)


def _relax_level(w, steps):
    """One level of a block: the window `w` shrunk by one cell per side,
    each cell relaxed over its 26 neighbours in _OFFSETS26 order."""
    a, b, c = w.shape
    acc = w[1:a - 1, 1:b - 1, 1:c - 1]
    for oa, ob, oc in PV._OFFSETS26.tolist():
        nb = w[1 + oa:a - 1 + oa, 1 + ob:b - 1 + ob, 1 + oc:c - 1 + oc]
        acc = torch.minimum(acc, nb + steps[oa * oa + ob * ob + oc * oc - 1])
    return acc


def _in_grid(lo, size, n):
    """Mask of window positions lo .. lo + size - 1 inside [0, n)."""
    g = torch.arange(lo, lo + size)
    return (g >= 0) & (g < n)


def tiled_chamfer(phi, dx, passes, sms, blocks_per_sm, remask=True):
    """K4 on `phi` as its blocks compute it: one launch per chamfer_chunks
    entry, each with the geometry of tiles(sms, blocks_per_sm).
    Returns (out, writes): writes counts how often each cell was stored.
    remask=False keeps the relaxed values of window cells outside the grid
    (the fault the kernel must not have)."""
    ni, nj, nk = phi.shape
    steps = PV.chamfer_steps(dx)
    writes = torch.zeros(phi.shape, dtype=torch.int64)
    for p in vdt_kernel.chamfer_chunks(passes):
        tj, tk, seg = tiles(phi.shape, p, sms, blocks_per_sm)
        out = torch.full(phi.shape, float("nan"))
        src = torch.nn.functional.pad(phi, (p, p + tk, p, p + tj, p, p + seg),
                                      value=float(BIG))
        for i0 in range(0, ni, seg):
            i1 = min(i0 + seg, ni)
            for j0 in range(0, nj, tj):
                for k0 in range(0, nk, tk):
                    # the window in global coordinates: planes i0 - p ..
                    # i1 + p - 1, rows j0 - p .., columns k0 - p ..
                    shape = (i1 - i0 + 2 * p, tj + 2 * p, tk + 2 * p)
                    lo = (i0 - p, j0 - p, k0 - p)
                    w = src[i0:i0 + shape[0], j0:j0 + shape[1],
                            k0:k0 + shape[2]].clone()
                    for level in range(1, p + 1):
                        w = _relax_level(w, steps)
                        lo = tuple(x + 1 for x in lo)
                        inside = (_in_grid(lo[0], w.shape[0], ni)[:, None, None]
                                  & _in_grid(lo[1], w.shape[1], nj)[None, :, None]
                                  & _in_grid(lo[2], w.shape[2], nk)[None, None, :])
                        if remask:
                            w = torch.where(inside, w, torch.tensor(BIG))
                    assert lo == (i0, j0, k0) and w.shape == (i1 - i0, tj, tk)
                    jn, kn = min(tj, nj - j0), min(tk, nk - k0)
                    out[i0:i1, j0:j0 + jn, k0:k0 + kn] = w[:, :jn, :kn]
                    writes[i0:i1, j0:j0 + jn, k0:k0 + kn] += 1
        phi = out
    return phi, writes


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(size=shape)).astype(np.float32)


def _bits(x):
    return np.asarray(x).view(np.int32)


# (shape, sms, blocks per SM): tiles that overhang the grid in j and k,
# segments of 1 plane up to the whole of i, grids smaller than a tile
CASES = [((48, 41, 75), 132, 3), ((17, 40, 31), 132, 3),
         ((130, 5, 66), 132, 3), ((48, 41, 75), 1, 1),
         ((9, 70, 130), 4, 2), ((3, 2, 1), 132, 3)]


@pytest.mark.parametrize("passes", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tiling_bit_equal_to_twin(case, passes):
    """The transcription of K4's blocks equals vdt.chamfer_relax bit for
    bit, and its blocks store every cell once per launch."""
    shape, sms, per_sm = CASES[case]
    phi = torch.from_numpy(_field(shape, case))
    got, writes = tiled_chamfer(phi, float(DX), passes, sms, per_sm)
    want = PV.chamfer_relax(phi, float(DX), passes)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert bool((writes == len(vdt_kernel.chamfer_chunks(passes))).all())


@pytest.mark.parametrize("passes", [1, 2, 3, 5])
def test_tiling_bit_equal_to_jax(passes):
    """The transcription against the JAX package's chamfer_relax."""
    phi = _field((21, 37, 70), 10 + passes)
    got, _ = tiled_chamfer(torch.from_numpy(phi), float(DX), passes, 132, 3)
    want = JV.chamfer_relax(jnp.asarray(phi), DX, passes=passes)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("passes", [1, 2, 4])
def test_tiling_bit_equal_to_pallas(passes):
    """The transcription against the Pallas kernel in interpret mode, at a
    shape its kernel takes (no jnp fallback) and whose j and k tiles
    overhang."""
    phi = _field((44, 40, 70), 20 + passes)
    got, _ = tiled_chamfer(torch.from_numpy(phi), float(DX), passes, 132, 3)
    want = pallas_chamfer(jnp.asarray(phi), DX, passes=passes, interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# Grids one cell thin and a negative dx (negative steps): a path through a
# window cell outside the grid can then be shorter than any path inside it
# (a corner step out and back beats two edge steps inside), so a kernel
# that let such a cell keep its relaxed value, instead of reading 3e38
# before every pass, would differ from the twin. chip_smoke.py runs these
# inputs through the CUDA kernel.
THIN = [((12, 1, 70), 2), ((9, 33, 1), 3), ((1, 40, 66), 2), ((5, 1, 1), 4)]


@pytest.mark.parametrize("case", range(len(THIN)))
def test_outside_cells_read_big_at_every_pass(case):
    shape, passes = THIN[case]
    phi = torch.from_numpy(_field(shape, 30 + case))
    want = PV.chamfer_relax(phi, -0.5, passes)
    got, _ = tiled_chamfer(phi, -0.5, passes, 132, 3)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    stale, _ = tiled_chamfer(phi, -0.5, passes, 132, 3, remask=False)
    assert not torch.equal(stale, want)


def test_chunks_and_tiles():
    """One launch for 1-4 passes, none for 0; at 256^3 the segments fill
    the H100 (132 SMs, 3 blocks of 2 passes each) in one wave, each
    segment several times its 2P-plane warm-up."""
    assert vdt_kernel.chamfer_chunks(0) == []
    assert vdt_kernel.chamfer_chunks(-1) == []
    assert [vdt_kernel.chamfer_chunks(p) for p in (1, 2, 4)] == [[1], [2], [4]]
    assert vdt_kernel.chamfer_chunks(5) == [4, 1]
    assert vdt_kernel.chamfer_chunks(9) == [4, 4, 1]
    tj, tk, seg = tiles((256,) * 3, 2, 132, 3)
    blocks = -(-256 // tj) * -(-256 // tk) * -(-256 // seg)
    assert 2 * 132 < blocks <= 3 * 132
    assert seg >= 4 * 2
