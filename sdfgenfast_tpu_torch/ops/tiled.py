"""Tile-row layout helpers (counterpart of ``sdfgenfast_tpu/ops/tiled.py``;
only ``untile_rows`` is on the binned exact path)."""

from __future__ import annotations

__all__ = ["untile_rows"]


def untile_rows(rows, tile_shape, tiles_dim, grid_shape):
    """(T, C) tile rows -> dense (ni, nj, nk) grid (pure reshape+permute,
    no scatter — for kernels that emit rows for EVERY tile)."""
    ni, nj, nk = grid_shape
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    x = rows.reshape(nti, ntj, ntk, ti, tj, tk)
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(nti * ti, ntj * tj, ntk * tk)
    return x[:ni, :nj, :nk].contiguous()
