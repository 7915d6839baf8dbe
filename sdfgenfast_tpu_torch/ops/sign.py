"""Inside/outside sign on the device: the x-ray parity of
``SDFConfig(sign_mode="device")``.

Counterpart of ``sdfgenfast_tpu/ops/sign.py``. The reference casts one ray
per (j, k) grid line along +x, tests each triangle whose clamped (j, k)
window holds the line with float64 SOS orientation predicates, counts a
crossing at i = ceil(fi) (< 0 counted at 0, >= ni dropped) and flips the
sign where the prefix count along i is odd
(``cpu_lib/makelevelset3.cpp:155-187, 222-235, 295-303``).

Host half (NumPy, the same tiles and candidate matrices as the JAX
package, bit for bit): triangles are binned to 2D (j, k) tiles
(:func:`bin_triangles_2d`). The binning carries the float64 grid
coordinates ``f`` and each triangle's clamped window, not the JAX
package's double-float split: the card has hardware float64.

Device half (:func:`parity_field`, plain torch on the tensors' device): the
predicates in float64 in the host parity's operation order
(``ops/sign_host.parity_field_host``: one division,
``(a*fi0 + b*fi1 + c*fi2) / total``), each operation its own torch op
(no fused multiply-add, no reduction), so that the CPU and the card
round alike and the field equals the host parity on every cell. Each hit
is counted once into a per-tile (C, ni + 1) integer field by
``index_add_`` (integer sums do not depend on their order), and the
parity is the count's prefix sum along i, taken mod 2; the JAX package's
(B, C, K, ni) compare is never formed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..grid import GridSpec
from .band import _round_up, triangle_grid_coords

__all__ = ["DEFAULT_TILE_2D", "SignBinning", "bin_triangles_2d",
           "parity_field", "triangle_windows"]

DEFAULT_TILE_2D = (16, 16)


@dataclasses.dataclass(frozen=True)
class SignBinning:
    """2D (j, k)-tile binning for the sign pass (host-side NumPy).

    f: (M, 3, 3) float64 per-vertex grid coordinates (fi, fj, fk);
    window: (M, 4) int32 clamped (j0, j1, k0, k1) of each triangle, the
    cells the reference tests it on (:func:`triangle_windows`)."""

    tile_shape: Tuple[int, int]
    tiles_dim: Tuple[int, int]
    active_ids: np.ndarray  # (A,) linear tile index (j-major: tj*ntk + tk)
    cand: np.ndarray  # (A, K)
    cand_valid: np.ndarray  # (A, K)
    f: np.ndarray
    window: np.ndarray


def triangle_windows(f: np.ndarray, nj: int, nk: int) -> np.ndarray:
    """(M, 4) int32 (j0, j1, k0, k1): j0 = clamp(ceil(min fj), 0, nj-1),
    j1 = clamp(floor(max fj), 0, nj-1), the same in k
    (makelevelset3.cpp:222-225). A window clamped to [0, 0] or
    [n-1, n-1] is nonempty, as the reference's; a window with j1 < j0 or
    k1 < k0 is empty."""
    fj = f[:, :, 1]
    fk = f[:, :, 2]
    j0 = np.clip(np.ceil(fj.min(1)).astype(np.int64), 0, nj - 1)
    j1 = np.clip(np.floor(fj.max(1)).astype(np.int64), 0, nj - 1)
    k0 = np.clip(np.ceil(fk.min(1)).astype(np.int64), 0, nk - 1)
    k1 = np.clip(np.floor(fk.max(1)).astype(np.int64), 0, nk - 1)
    return np.stack([j0, j1, k0, k1], axis=1).astype(np.int32)


def bin_triangles_2d(
    verts: np.ndarray,
    tris: np.ndarray,
    grid: GridSpec,
    tile_shape: Tuple[int, int] = DEFAULT_TILE_2D,
    pad_k_to: int = 8,
) -> SignBinning:
    ni, nj, nk = grid.shape
    tj, tk = tile_shape
    ntj, ntk = _round_up(nj, tj) // tj, _round_up(nk, tk) // tk

    f = triangle_grid_coords(verts, tris, grid)  # (M, 3, 3) float64
    window = triangle_windows(f, nj, nk)
    j0, j1, k0, k1 = (window[:, c].astype(np.int64) for c in range(4))
    nonempty = (j1 >= j0) & (k1 >= k0)

    tlo_j = j0 // tj
    thi_j = j1 // tj
    tlo_k = k0 // tk
    thi_k = k1 // tk
    span_j = np.where(nonempty, thi_j - tlo_j + 1, 0)
    span_k = np.where(nonempty, thi_k - tlo_k + 1, 0)
    counts = span_j * span_k
    total = int(counts.sum())

    if total == 0:
        return SignBinning(
            tile_shape, (ntj, ntk),
            np.zeros((0,), np.int32),
            np.zeros((0, pad_k_to), np.int32),
            np.zeros((0, pad_k_to), bool),
            f, window,
        )

    tri_ids = np.repeat(np.arange(len(tris), dtype=np.int64), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    sk = span_k[tri_ids]
    dk = rank % sk
    dj = rank // sk
    tile_j = tlo_j[tri_ids] + dj
    tile_k = tlo_k[tri_ids] + dk
    tile_lin = tile_j * ntk + tile_k

    order = np.argsort(tile_lin, kind="stable")
    tile_lin = tile_lin[order]
    tri_ids = tri_ids[order]
    uniq, starts, per_tile = np.unique(tile_lin, return_index=True,
                                       return_counts=True)
    K = _round_up(max(int(per_tile.max()), 1), pad_k_to)
    A = len(uniq)
    cand = np.zeros((A, K), np.int32)
    valid = np.zeros((A, K), bool)
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, per_tile)
    row = np.repeat(np.arange(A, dtype=np.int64), per_tile)
    cand[row, pos] = tri_ids.astype(np.int32)
    valid[row, pos] = True
    return SignBinning(tile_shape, (ntj, ntk), uniq.astype(np.int32), cand,
                       valid, f, window)


# ---------------------------------------------------------------------------
# Device predicates (float64)
# ---------------------------------------------------------------------------


def _compare(x, y):
    """sign(x - y) as int8, from the compares themselves."""
    return (x > y).to(torch.int8) - (x < y).to(torch.int8)


def _orientation(x1, y1, x2, y2):
    """SOS-determined sign (int8) of twice the signed area of
    (0,0)-(x1,y1)-(x2,y2), and the area (makelevelset3.cpp:155-165): the
    area's sign, else y2 > y1 -> +1, y2 < y1 -> -1, x1 > x2 -> +1,
    x1 < x2 -> -1, else 0."""
    area = y1 * x2 - x1 * y2
    s = _compare(area, 0.0)
    sy = _compare(y2, y1)
    tie = torch.where(sy != 0, sy, _compare(x1, x2))
    return torch.where(s != 0, s, tie), area


def _crossing_bins(fc, win, valid, jj, kk, ni: int):
    """The crossing bin of each (tile, cell, candidate), ni where none.

    fc (B, 1, K, 3, 3) float64 candidate coordinates, win (B, 1, K, 4) their
    windows, valid (B, 1, K), jj and kk (B, C, 1) int64 global (j, k) of
    each cell's ray. Mirrors ``ops/sign_host.parity_field_host``: the
    point-in-triangle test at (j, k) inside the triangle's window, then
    i = ceil((a*fi0 + b*fi1 + c*fi2) / (a + b + c)), dropped at >= ni and
    counted at 0 below it. Returns (B, C, K) int64 in [0, ni]."""
    in_box = ((jj >= win[..., 0]) & (jj <= win[..., 1])
              & (kk >= win[..., 2]) & (kk <= win[..., 3]) & valid)
    jf = jj.to(torch.float64)
    kf = kk.to(torch.float64)
    x1, y1 = fc[..., 0, 1] - jf, fc[..., 0, 2] - kf
    x2, y2 = fc[..., 1, 1] - jf, fc[..., 1, 2] - kf
    x3, y3 = fc[..., 2, 1] - jf, fc[..., 2, 2] - kf
    sa, a = _orientation(x2, y2, x3, y3)
    sb, b = _orientation(x3, y3, x1, y1)
    sc, c = _orientation(x1, y1, x2, y2)
    del x1, y1, x2, y2, x3, y3
    inside = (sa != 0) & (sb == sa) & (sc == sa) & in_box
    total = a + b + c
    # the host's guard: the reference asserts total != 0 where inside holds
    total = torch.where(total == 0.0, torch.ones_like(total), total)
    fint = (a * fc[..., 0, 0] + b * fc[..., 1, 0] + c * fc[..., 2, 0]) / total
    cb = torch.ceil(fint)
    hit = inside & (cb < ni)  # >= ni dropped (makelevelset3.cpp:233)
    # < 0 counted at interval 0 (:231)
    cb = torch.where(hit, cb.clamp(min=0.0), torch.full_like(cb, ni))
    return cb.to(torch.int64)


def parity_field(
    f,  # (M, 3, 3) float64
    window,  # (M, 4) int32
    active_ids,  # (A,) int32; sentinel T rows are dropped
    cand,  # (A, K) int32
    cand_valid,  # (A, K) bool
    tile_shape: Tuple[int, int],
    tiles_dim: Tuple[int, int],
    grid_shape: Tuple[int, int, int],
    chunk: int = 64,
    jk_offset=None,
):
    """Dense (ni, nj, nk) bool parity (True = inside) on the tensors'
    device, `chunk` tiles at a time.

    `jk_offset` ((j, k) ints or a (2,) integer tensor; None = zeros) is the
    global (j, k) of local cell (0, 0): a block of tiles cut from the
    global binning and relabelled to local tile ids sees the same rays as
    the global field. `f` and `window` are the global grid's
    (:class:`SignBinning`). Nothing here waits for the device, so a
    caller's host work overlaps the field's kernels."""
    ni, nj, nk = (int(v) for v in grid_shape)
    tj, tk = (int(v) for v in tile_shape)
    ntj, ntk = (int(v) for v in tiles_dim)
    dev = f.device
    if f.dtype != torch.float64:
        raise ValueError(f"f must be float64, got {f.dtype}")
    if not (cand.device == window.device == active_ids.device
            == cand_valid.device == dev):
        raise ValueError("f, window, active_ids, cand and cand_valid must "
                         "share one device")
    C = tj * tk
    T = ntj * ntk
    A = int(active_ids.shape[0])
    rows = torch.zeros((T + 1, C, ni), dtype=torch.bool, device=dev)
    if A > 0:
        if isinstance(jk_offset, torch.Tensor):
            off = jk_offset.to(device=dev, dtype=torch.int64)
        else:
            off = (0, 0) if jk_offset is None else tuple(
                int(v) for v in jk_offset)
        cells = torch.arange(C, dtype=torch.int64, device=dev)
        local_j, local_k = cells // tk, cells % tk
        B = min(int(chunk), A)
        for s in range(0, A, B):
            ids = active_ids[s:s + B].to(torch.int64)
            cd = cand[s:s + B].to(torch.int64)
            b = ids.shape[0]
            jj = ((ids // ntk)[:, None] * tj + local_j + off[0])[:, :, None]
            kk = ((ids % ntk)[:, None] * tk + local_k + off[1])[:, :, None]
            bins = _crossing_bins(f[cd][:, None], window[cd][:, None],
                                  cand_valid[s:s + B][:, None], jj, kk, ni)
            # one count per hit at (tile, cell, bin); misses land in bin ni
            base = torch.arange(b * C, dtype=torch.int64,
                                device=dev).reshape(b, C, 1) * (ni + 1)
            counts = torch.zeros(b * C * (ni + 1), dtype=torch.int32,
                                 device=dev)
            counts.index_add_(0, (base + bins).reshape(-1),
                              torch.ones(bins.numel(), dtype=torch.int32,
                                         device=dev))
            counts = counts.reshape(b, C, ni + 1)[..., :ni]
            par = (torch.cumsum(counts & 1, dim=2, dtype=torch.int32) & 1
                   ).to(torch.bool)
            # active ids are unique; every sentinel row lands in row T
            rows.index_copy_(0, ids.clamp(max=T), par)
    x = rows[:T].reshape(ntj, ntk, tj, tk, ni)
    x = x.permute(4, 0, 2, 1, 3).reshape(ni, ntj * tj, ntk * tk)
    return x[:, :nj, :nk].contiguous()
