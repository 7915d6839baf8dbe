"""End-to-end SDF pipeline in PyTorch: every far-field mode and both sign
modes of the JAX package on one device.

Counterpart of ``sdfgenfast_tpu/pipeline.py``. The path splits on the
far-field mode and, in ``"exact"`` mode, on the triangle count
(:func:`use_dense`), as in the JAX package. The sign comes from the x-ray
parity: with ``sign_mode="host"`` the host computes it (crossings or
bit-packed) while binning; with ``sign_mode="device"`` the host bins the
triangles to 2D (j, k) tiles and ``ops/sign.parity_field`` evaluates the
float64 predicates on the device, equal to the host parity on every cell.

Dense path (``"exact"``, at most ``dense_max_tris`` triangles,
:func:`dense_sign_core`):

  1. host: the x-ray parity (or the 2D sign binning), no band binning;
  2. device: vertex gather -> K1 (one kernel up to 1024 triangles): the
     exact distance of every cell to every triangle -> sign from the parity.

Binned exact path (``"exact"``, :func:`exact_core`):

  1. host: native band binning (seed band max(exact_band, 3), pruned) +
     x-ray parity (or the 2D sign binning), exactly the JAX package's host
     layer;
  2. device, the band: 8^3 tiles through the K2 kernel over CSR candidate
     segments; any other tile shape through the tile evaluator
     (``ops/tiled.py``) over the padded (A, K) candidate matrices; exact
     band distances, winner ids and closest points -> freeze mask;
  3. device, the far field, by schedule: by default the coarse-to-fine
     closest-point pyramid, its Jacobi rounds in K3, run in the JAX
     package's axis permutation; with ``vdt_max_hop`` the capped ladder
     (every round Jacobi, in K3); with only ``vdt_extra_rounds`` the flat
     ladder (Gauss-Seidel rounds in torch, strides 2 and 4 in K3);
  4. device: K4 chamfer relaxation, then the sign from the parity.

``"propagate"`` and ``"eikonal"`` (:func:`sweep_core`): the host bins with
``prune=False`` and the seed band ``exact_band``; on the device
``ops/band.band_distance_field`` gives the band, then

  - ``"propagate"``: directional plane scans of closest-triangle ids to
    their fixed point (``ops/sweep.py``, one host sync a pass), and phi is
    evaluated again from the ids by R1 (``ops/recompute.py``);
  - ``"eikonal"``: Jacobi relaxation of |grad phi| = 1 outside the seeded
    band; the band's phi is evaluated again from its ids by R1.

Vertex gradients (``make_level_set3(..., verts=...)``): the distance
pipeline runs without gradients and keeps only the closest-triangle ids;
phi is then evaluated again from the vertices by the recompute kernels
R1/R1b, so the gradient reaches `verts` through every cell (``"eikonal"``:
through the seeded band only).

Every step takes an explicit ``torch.device``. CUDA tensors go through the
hand-written kernels; CPU tensors through their plain-torch twins. The
modules with no Pallas counterpart (the tile evaluator, the Gauss-Seidel
rounds, ``band_distance_field``, the sweeps) are plain torch on either
device. The same steps over a (j, k) mesh of devices are
``parallel/sharded.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .grid import GridSpec
from .mesh import Mesh
from .ops import band as band_ops
from .ops import band_kernel
from .ops import dense as dense_ops
from .ops import recompute as recompute_ops
from .ops import sign as sign_ops
from .ops import sign_host as sign_host_ops
from .ops import sweep as sweep_ops
from .ops import tiled as tiled_ops
from .ops import vdt as vdt_ops
from .ops import vdt_kernel
from . import tracing, upload

__all__ = ["SDFConfig", "Binned", "bin_mesh", "binned_from_arrays",
           "check_supported", "dense_sign_core", "exact_core",
           "ladder_schedule", "make_level_set3", "sweep_core", "use_dense"]

DENSE_MAX_TRIS = dense_ops.DENSE_MAX_TRIS


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """Pipeline configuration: the same fields and defaults as
    ``sdfgenfast_tpu.pipeline.SDFConfig``, checked by
    :func:`check_supported`. ``tile2d_shape`` and ``sign_chunk`` are the
    device sign's 2D tiles and tiles a chunk."""

    exact_band: int = 1
    far_field: str = "exact"
    sign_mode: str = "host"
    parity_transport: str = "auto"
    tile_shape: Tuple[int, int, int] = band_ops.DEFAULT_TILE
    tile2d_shape: Tuple[int, int] = sign_ops.DEFAULT_TILE_2D
    max_passes: int = 64
    vdt_extra_rounds: Optional[int] = None
    vdt_max_hop: Optional[int] = None
    chamfer_passes: int = 2
    dense_max_tris: int = DENSE_MAX_TRIS
    eikonal_iters: Optional[int] = None
    band_chunk: int = 128
    sign_chunk: int = 64


@dataclasses.dataclass(frozen=True)
class Binned:
    """Host-side preprocessing product (NumPy arrays).

    The sign: with ``sign_mode="host"`` exactly one of parity_packed
    ((ceil(ni/8), nj, nk) uint8) and parity_crossings ((C, nj, nk) int16)
    is set; with ``"device"`` neither is, and `sign` holds the 2D (j, k)
    binning, its active ids padded by :func:`_bucket` with the sentinel
    tile id T (rows of no valid candidate). The band binning is None
    on the dense path, which bins nothing; otherwise tiles_dim is the
    (nti, ntj, ntk) grid of `tile_shape` tiles and the candidates come in
    the layout that the route reads (:func:`reads_csr`):

    - band_csr, K2's CSR layout (``"exact"`` with 8^3 tiles): "pair" (P,)
      candidate ids (sentinel M pads), "off"/"cnt"/"ids" (A_pad,) per
      active tile segment starts, lengths and linear tile ids (sentinel T
      pads), "kcap" the largest segment rounded up to 64;
    - active_ids (A_pad,) int32 (sentinel T pads), cand (A_pad, K) int32
      and cand_valid (A_pad, K) bool, the padded candidate matrices of the
      tile evaluator and ``band_distance_field`` (every other route).

    seed_band: the band the candidates were binned with (the freeze
    threshold never exceeds it).

    device: the binning's arrays and the mesh's vertices uploaded as one
    blob (``upload.DeviceBlob``: the views and the torch.device they live
    on), made at bin time by ``bin_mesh(..., device=...)``;
    :func:`make_level_set3` on that device reads them and uploads nothing.
    None for a host-only binning.
    """

    grid: GridSpec
    config: SDFConfig
    tris: np.ndarray  # (M, 3) int32
    tiles_dim: Optional[Tuple[int, int, int]] = None
    band_csr: Optional[dict] = None
    parity_packed: Optional[np.ndarray] = None
    parity_crossings: Optional[np.ndarray] = None
    seed_band: int = 3
    tile_shape: Tuple[int, int, int] = band_ops.DEFAULT_TILE
    active_ids: Optional[np.ndarray] = None
    cand: Optional[np.ndarray] = None
    cand_valid: Optional[np.ndarray] = None
    sign: Optional[sign_ops.SignBinning] = None
    device: Optional[upload.DeviceBlob] = None


# the device sign's arrays in the blob: SignBinning's f, window, active_ids,
# cand and cand_valid, in parity_field's order
_SIGN_NAMES = ("sign_f", "sign_window", "sign_ids", "sign_cand", "sign_valid")


def _blob_arrays(binned: "Binned", verts) -> dict:
    """Every array a call on `binned` can read, by its name in the blob:
    the mesh's vertices `verts`, the triangles, the origin, the host
    parity's transport, the band binning's CSR or (A, K) matrices and the
    device sign's binning."""
    a = {"verts": np.ascontiguousarray(verts, np.float32),
         "tris": binned.tris,
         "origin": np.asarray(binned.grid.origin, np.float32)}
    if binned.parity_packed is not None:
        a["parity"] = binned.parity_packed
    if binned.parity_crossings is not None:
        a["crossings"] = binned.parity_crossings
    if binned.band_csr is not None:
        a.update((k, binned.band_csr[k]) for k in ("pair", "off", "cnt",
                                                    "ids"))
    if binned.active_ids is not None:
        a.update(active_ids=binned.active_ids, cand=binned.cand,
                 cand_valid=binned.cand_valid)
    sb = binned.sign
    if sb is not None:
        a.update(zip(_SIGN_NAMES, (sb.f, sb.window, sb.active_ids, sb.cand,
                                   sb.cand_valid)))
    return a


def _uploaded(binned: "Binned", verts, device) -> "Binned":
    """`binned` with its arrays and `verts` uploaded to `device` as one blob
    (unchanged for device None)."""
    if device is None:
        return binned
    return dataclasses.replace(binned, device=upload.pack_device_blob(
        _blob_arrays(binned, verts), device))


def _bucket(n: int, minimum: int = 64, shift: int = 4) -> int:
    """Round up to a coarse bucket (quantum 2^(bits-shift), <~6% padding).
    Kept from the JAX package so the binned arrays are byte-equal to its."""
    if n <= minimum:
        return minimum
    p = 1 << max(int(n - 1).bit_length() - shift, 3)
    return -(-n // p) * p


def _vdt_axis_perm(grid_shape):
    """The JAX package's axis order for the pyramid: largest dim last, next
    in the middle (it minimizes TPU lane padding). It means nothing on a GPU
    but is kept: it changes the greedy downsample tournaments, so results are
    comparable with the JAX package only under the same permutation."""
    best = (0, 1, 2)

    def padded_cells(p):
        d = [grid_shape[p[0]], grid_shape[p[1]], grid_shape[p[2]]]
        return d[0] * d[1] * (-(-d[2] // 128) * 128)

    for p in itertools.permutations((0, 1, 2)):
        if padded_cells(p) < padded_cells(best):
            best = p
    return best


def use_dense(config: SDFConfig, num_tris: int) -> bool:
    """True when the JAX package would take its dense all-triangles path."""
    cap = min(config.dense_max_tris, DENSE_MAX_TRIS)
    return config.far_field == "exact" and 0 < num_tris <= cap


def reads_csr(config: SDFConfig) -> bool:
    """True when the binned path's band comes from K2 over the CSR layout
    (``"exact"`` with 8^3 tiles); every other route reads the padded (A, K)
    candidate matrices."""
    return (config.far_field == "exact"
            and tuple(config.tile_shape) == (8, 8, 8))


def ladder_schedule(config: SDFConfig, grid_shape):
    """The exact far field's schedule, as ``sdfgenfast_tpu.pipeline.
    sdf_from_tri_verts`` picks it: None for the pyramid (neither
    ``vdt_max_hop`` nor ``vdt_extra_rounds`` set), else (strides, jacobi)
    of the capped (``vdt_max_hop``: every round Jacobi) or flat ladder,
    with ``vdt_extra_rounds`` polish rounds (default 2 up to 256 cells, 4
    above)."""
    if config.vdt_max_hop is None and config.vdt_extra_rounds is None:
        return None
    extra = config.vdt_extra_rounds
    if extra is None:
        extra = 2 if max(grid_shape) <= 256 else 4
    strides = vdt_ops.stride_ladder(max(grid_shape),
                                    max_hop=config.vdt_max_hop,
                                    extra_rounds=extra)
    return strides, config.vdt_max_hop is not None


def check_supported(config: SDFConfig, num_tris: int) -> None:
    """Raise ValueError for unknown modes and bad tile shapes."""
    if config.far_field not in ("exact", "propagate", "eikonal"):
        raise ValueError(f"unknown far_field mode: {config.far_field}")
    if config.sign_mode not in ("host", "device"):
        raise ValueError(f"unknown sign_mode: {config.sign_mode}")
    if len(tuple(config.tile_shape)) != 3 or min(config.tile_shape) < 1:
        raise ValueError(f"bad tile_shape: {config.tile_shape}")
    if config.sign_mode == "device" and (
            len(tuple(config.tile2d_shape)) != 2
            or min(config.tile2d_shape) < 1):
        raise ValueError(f"bad tile2d_shape: {config.tile2d_shape}")
    del num_tris


def _host_parity_choose(mesh, grid, mode, min_cross_rows=0):
    """Host parity in the requested transport: (packed, crossings), one None.
    "auto" computes the SOS predicates once (as crossings) and keeps
    whichever encoding is smaller."""
    if mode == "auto":
        cross = sign_host_ops.crossings_host(
            mesh.verts, mesh.tris, grid, min_rows=min_cross_rows)
        if cross.shape[0] * 2 < -(-grid.shape[0] // 8):
            return None, cross
        return sign_host_ops.packed_from_crossings(
            cross, grid.shape[0]), None
    if mode == "crossings":
        return None, sign_host_ops.crossings_host(
            mesh.verts, mesh.tris, grid, min_rows=min_cross_rows)
    if mode != "packed":
        raise ValueError(f"unknown parity_transport: {mode}")
    return sign_host_ops.parity_packed_host(
        mesh.verts, mesh.tris, grid), None


def _sign_binning(mesh: Mesh, grid: GridSpec, config: SDFConfig):
    """The device sign's 2D binning, its active ids padded by _bucket with
    the sentinel tile id T (``sdfgenfast_tpu.pipeline.bin_mesh``)."""
    sb = sign_ops.bin_triangles_2d(mesh.verts, mesh.tris, grid,
                                   tuple(int(v) for v in config.tile2d_shape))
    A = len(sb.active_ids)
    A_pad = _bucket(A)
    ids = np.pad(sb.active_ids, (0, A_pad - A),
                 constant_values=int(np.prod(sb.tiles_dim)))
    pad = ((0, A_pad - A), (0, 0))
    return dataclasses.replace(sb, active_ids=ids, cand=np.pad(sb.cand, pad),
                               cand_valid=np.pad(sb.cand_valid, pad))


def bin_mesh(mesh: Mesh, grid: GridSpec, config: SDFConfig = SDFConfig(),
             min_cross_rows: int = 0, device=None) -> Binned:
    """Host-side preprocessing for :func:`make_level_set3`: the x-ray
    parity (host sign) or the 2D sign binning (device sign), plus band
    binning on the binned path, in the layout the route reads
    (``sdfgenfast_tpu.pipeline.bin_mesh``). In device sign mode the JAX
    package bins the band on the dense path too, which reads none of it;
    the port does not. `min_cross_rows` pads the crossings transport's row
    count. With a `device`, the binning and the mesh's vertices go up to it
    as one blob, kept in ``Binned.device``."""
    with tracing.span("sdf.bin_mesh"):
        binned = _bin_host(mesh, grid, config, min_cross_rows)
        with tracing.span("sdf.bin.upload"):
            return _uploaded(binned, mesh.verts, device)


def _bin_host(mesh: Mesh, grid: GridSpec, config: SDFConfig,
              min_cross_rows: int) -> Binned:
    """:func:`bin_mesh` without the upload."""
    mesh.validate_indices()
    check_supported(config, len(mesh.tris))
    packed = cross = sign = None
    with tracing.span("sdf.bin.parity", ranged=True):
        if config.sign_mode == "host":
            packed, cross = _host_parity_choose(
                mesh, grid, config.parity_transport, min_cross_rows)
        else:
            sign = _sign_binning(mesh, grid, config)
    tris = mesh.tris.astype(np.int32)
    if use_dense(config, len(mesh.tris)):
        return Binned(grid, config, tris, parity_packed=packed,
                      parity_crossings=cross, sign=sign)
    # the exact far field: a >=3-cell seed band makes the 27-neighbourhood
    # union cover the true closest triangle for near-band cells; the
    # propagate/eikonal modes bin the band itself, unpruned (they rely on
    # the L-inf dilation's extra seeds)
    exact = config.far_field == "exact"
    seed_band = max(config.exact_band, 3) if exact else config.exact_band
    tile_shape = tuple(int(v) for v in config.tile_shape)
    with tracing.span("sdf.bin.band", ranged=True):
        bb = band_ops.bin_triangles(mesh.verts, mesh.tris, grid, seed_band,
                                    tile_shape, prune=exact)
        T = int(np.prod(bb.tiles_dim))
        A_pad = _bucket(bb.num_active)
        ids = np.pad(bb.active_ids, (0, A_pad - bb.num_active))
        ids[bb.num_active:] = T
        if not reads_csr(config):
            pad = ((0, A_pad - bb.num_active), (0, 0))
            return Binned(
                grid, config, tris, bb.tiles_dim, None, packed, cross,
                seed_band, tile_shape, active_ids=ids,
                cand=np.pad(bb.cand, pad),
                cand_valid=np.pad(bb.cand_valid, pad), sign=sign)
    with tracing.span("sdf.bin.csr", ranged=True):
        pair, off, cnt = band_kernel.band_csr_from_binning(
            bb.cand, bb.cand_valid, int(len(mesh.tris)))
        off = np.pad(off, (0, A_pad - len(off)))
        cnt = np.pad(cnt, (0, A_pad - len(cnt)))
        P_pad = _bucket(len(pair), minimum=128)
        pair = np.pad(pair, (0, P_pad - len(pair)),
                      constant_values=len(mesh.tris))
        kcap = max(-(-int(cnt.max() or 1) // 64) * 64, 64)
    csr = {"pair": pair, "off": off, "cnt": cnt, "kcap": kcap, "ids": ids}
    return Binned(grid, config, tris, bb.tiles_dim, csr, packed, cross,
                  seed_band, tile_shape, sign=sign)


def binned_from_arrays(grid: GridSpec, config: SDFConfig, *, tris,
                       tiles_dim=None, pair=None, off=None, cnt=None, ids=None,
                       kcap=None, active_ids=None, cand=None, cand_valid=None,
                       tile_shape=(8, 8, 8), parity_packed=None,
                       parity_crossings=None, seed_band: int = 3,
                       sign_ids=None, sign_cand=None, sign_valid=None,
                       sign_f=None, tile2d_shape=None,
                       tiles2d_dim=None) -> Binned:
    """Build the port's Binned from another binning's NumPy arrays (e.g. a
    ``sdfgenfast_tpu`` Binned: its ``band_csr`` entries, its padded
    ``band.active_ids`` / ``band.cand`` / ``band.cand_valid``, and its
    parity or its padded sign binning), so both packages can run from
    identical host state. A dense Binned carries the triangles and the sign
    only: leave every band array None. A binned one gives tiles_dim and the
    CSR (pair, off, cnt, ids, kcap), the (A, K) matrices (active_ids, cand,
    cand_valid), or both. The sign is one of parity_packed,
    parity_crossings and the device sign's binning: sign_ids, sign_cand,
    sign_valid (``sign.active_ids`` / ``cand`` / ``cand_valid``),
    tile2d_shape, tiles2d_dim, and sign_f, the (M, 3, 3) float64 grid
    coordinates (``ops.band.triangle_grid_coords``; the JAX package keeps
    only their double-float split)."""
    sign_arrays = (sign_ids, sign_cand, sign_valid, sign_f, tile2d_shape,
                   tiles2d_dim)
    if any(v is None for v in sign_arrays) and any(
            v is not None for v in sign_arrays):
        raise ValueError("give all of sign_ids, sign_cand, sign_valid, "
                         "sign_f, tile2d_shape, tiles2d_dim or none")
    if sum(v is not None for v in (parity_packed, parity_crossings,
                                   sign_ids)) != 1:
        raise ValueError("give exactly one of parity_packed / "
                         "parity_crossings / the sign binning")
    sign = None
    if sign_ids is not None:
        f = np.asarray(sign_f, np.float64)
        sign = sign_ops.SignBinning(
            tuple(int(v) for v in tile2d_shape),
            tuple(int(v) for v in tiles2d_dim),
            np.asarray(sign_ids, np.int32), np.asarray(sign_cand, np.int32),
            np.asarray(sign_valid, bool), f,
            sign_ops.triangle_windows(f, *grid.shape[1:]))
    csr_arrays = (pair, off, cnt, ids, kcap)
    mats = (active_ids, cand, cand_valid)
    if tiles_dim is None:
        if any(v is not None for v in csr_arrays + mats):
            raise ValueError("band arrays need tiles_dim")
        csr = None
    else:
        tiles_dim = tuple(int(v) for v in tiles_dim)
        if any(v is None for v in csr_arrays) and any(
                v is not None for v in csr_arrays):
            raise ValueError("give all of pair, off, cnt, ids, kcap or none")
        if any(v is None for v in mats) and any(v is not None for v in mats):
            raise ValueError("give all of active_ids, cand, cand_valid or none")
        if pair is None and active_ids is None:
            raise ValueError("a binned path needs the CSR (pair, off, cnt, "
                             "ids, kcap) or the (A, K) candidate matrices "
                             "(active_ids, cand, cand_valid)")
        csr = None if pair is None else {
            "pair": np.asarray(pair, np.int32),
            "off": np.asarray(off, np.int32),
            "cnt": np.asarray(cnt, np.int32),
            "ids": np.asarray(ids, np.int32), "kcap": int(kcap)}
    return Binned(
        grid, config, np.asarray(tris, np.int32), tiles_dim, csr,
        None if parity_packed is None else np.asarray(parity_packed, np.uint8),
        None if parity_crossings is None
        else np.asarray(parity_crossings, np.int16),
        int(seed_band), tuple(int(v) for v in tile_shape),
        None if active_ids is None else np.asarray(active_ids, np.int32),
        None if cand is None else np.asarray(cand, np.int32),
        None if cand_valid is None else np.asarray(cand_valid, bool), sign)


def _parity_device(parity_data, ni):
    """Parity for either host transport (bit-packed uint8 or int16
    crossing positions), or a ready bool field (the device sign's)."""
    if parity_data.dtype == torch.bool:
        return parity_data
    if parity_data.dtype == torch.int16:
        return sign_host_ops.parity_from_crossings_device(parity_data, ni)
    return sign_host_ops.unpack_parity_device(parity_data, ni)


def dense_sign_core(verts, tris, parity_data, origin, dx: float, *,
                    grid_shape):
    """The dense path on device tensors (``sdfgenfast_tpu.pipeline.
    _dense_sign_core``): vertex gather -> K1 -> sign from the parity.

    verts (N, 3) f32, tris (M, 3) int32, parity_data (uint8 packed, int16
    crossings or the bool field), origin (3,) f32, all on one device; dx a
    float32-representable float. Returns (signed phi, tid), each
    (ni, nj, nk)."""
    with tracing.span("sdf.dense.table", verts.device):
        table = dense_ops.sep_table(verts[tris.long()], origin)
    with tracing.span("sdf.dense.k1", verts.device):
        phi, tid = dense_ops.dense_stream(
            table, float(np.float32(dx)),
            grid_shape=tuple(int(n) for n in grid_shape))
    return _signed(phi, parity_data, grid_shape[0]), tid


def _signed(phi, parity_data, ni: int):
    """`phi` negated inside, by the parity of `parity_data`."""
    with tracing.span("sdf.sign", phi.device):
        return torch.where(_parity_device(parity_data, ni), -phi, phi)


def _band_k2(tri_local, band, dx: float, *, grid_shape, tiles_dim, **coord):
    """The band of 8^3 tiles from K2 over the CSR layout: dense (phi0,
    tid0, (cpx, cpy, cpz)). A shard's block passes K2's coordinate ids
    (`coord`: ``band_rows``'s coord_* arguments)."""
    T = int(np.prod(tiles_dim))
    rows = band_kernel.band_rows(
        tri_local.reshape(-1, 9).contiguous(), band["pair"], band["ids"],
        band["off"], band["cnt"], dx, tiles_dim=tiles_dim,
        grid_shape=grid_shape, **coord)
    phi0, tid0, *cps = (tiled_ops.untile_rows(r[:T], (8, 8, 8), tiles_dim,
                                              grid_shape) for r in rows)
    return phi0, tid0, tuple(cps)


def _band_tiles(tri_verts, band, origin, dx: float, *, grid_shape,
                tile_shape, tiles_dim, chunk: int, ijk_offset=None,
                upper=None):
    """The band of any tile shape from the tile evaluator over the padded
    (A, K) candidate matrices (the XLA branch of
    ``sdfgenfast_tpu.pipeline._exact_core``): dense (phi0, tid0, cps). A
    shard's block passes its `ijk_offset` and the global grid's `upper`
    (default: `grid_shape`'s)."""
    ids = band["active_ids"]
    kw = dict(tile_shape=tile_shape, tiles_dim=tiles_dim)
    if upper is None:
        upper = band_kernel._upper(grid_shape, dx)
    phi_rows, tid_rows = tiled_ops.tile_candidate_rows(
        tri_verts, ids, band["cand"], band["cand_valid"], origin, dx,
        grid_shape=grid_shape, chunk=chunk, ijk_offset=ijk_offset,
        upper_override=upper, **kw)
    table = tiled_ops.tri_affine_table(tri_verts - origin)
    cp_rows = tiled_ops.closest_point_rows(table, ids, tid_rows, dx,
                                           chunk=chunk, ijk_offset=ijk_offset,
                                           **kw)
    phi0, tid0 = tiled_ops.scatter_untile(phi_rows, tid_rows, ids, upper,
                                          grid_shape=grid_shape, **kw)
    cps = tuple(tiled_ops.scatter_rows(r, ids, float(vdt_ops.FAR),
                                       grid_shape=grid_shape, **kw)
                for r in cp_rows)
    return phi0, tid0, cps


def exact_core(verts, tris, band, parity_data, origin, dx: float, *,
               grid_shape, tiles_dim, seed_band: int, tile_shape=(8, 8, 8),
               ladder=None, chamfer_passes: int = 2, band_chunk: int = 128):
    """The binned exact pipeline on device tensors
    (``sdfgenfast_tpu.pipeline._exact_core``).

    verts (N, 3) f32, tris (M, 3) int32, parity_data (uint8 packed, int16
    crossings or the bool field), origin (3,) f32 tensors, all on one
    device; dx a float32-representable float. `band` holds the binning's
    int32/bool tensors in the layout the route reads: at 8^3 tiles K2's
    CSR ("ids", "pair", "off", "cnt"), at other tiles the tile evaluator's
    (A, K) matrices ("active_ids", "cand", "cand_valid"). `ladder` is
    :func:`ladder_schedule`'s (strides, jacobi), or None for the pyramid.
    Returns (signed phi, tid), each (ni, nj, nk).
    """
    device = verts.device
    with tracing.span("sdf.band", device):
        tri_verts = verts[tris.long()]
        if tuple(tile_shape) == (8, 8, 8):
            phi0, tid0, cps = _band_k2(tri_verts - origin, band, dx,
                                       grid_shape=grid_shape,
                                       tiles_dim=tiles_dim)
        else:
            phi0, tid0, cps = _band_tiles(
                tri_verts, band, origin, dx, grid_shape=grid_shape,
                tile_shape=tuple(tile_shape), tiles_dim=tiles_dim,
                chunk=band_chunk)
        freeze = (tid0 >= 0) & (phi0 <= float(np.float32(seed_band)
                                              * np.float32(dx)))

    with tracing.span("sdf.far_field", device):
        if ladder is not None:
            strides, jacobi = ladder
            phi, tid = vdt_ops.vdt_far_field(
                *cps, tid0, phi0, dx, strides, freeze_mask=freeze,
                jacobi=jacobi, phase=vdt_kernel.round_phase)
        else:
            # the JAX package's axis permutation (see _vdt_axis_perm)
            perm = _vdt_axis_perm(grid_shape)
            inv = tuple(int(v) for v in np.argsort(perm))

            def t(x):
                return x.permute(perm).contiguous()

            phi_p, tid_p = vdt_ops.vdt_pyramid_far_field(
                t(cps[perm[0]]), t(cps[perm[1]]), t(cps[perm[2]]), t(tid0),
                t(phi0), dx, freeze_mask=t(freeze),
                # extra_polish=2 is the JAX package's _exact_core default
                extra_polish=2, phase=vdt_kernel.round_phase)
            phi = phi_p.permute(inv).contiguous()
            tid = tid_p.permute(inv).contiguous()

    if chamfer_passes > 0:
        with tracing.span("sdf.chamfer", device):
            phi = vdt_kernel.chamfer(phi, dx, chamfer_passes)
    return _signed(phi, parity_data, grid_shape[0]), tid


def sweep_core(tri_verts, band, parity_data, origin, dx: float, *, mode,
               grid_shape, tile_shape, tiles_dim, band_chunk: int = 128,
               max_passes: int = 64, eikonal_iters=None):
    """The ``"propagate"`` and ``"eikonal"`` far fields on device tensors
    (``sdfgenfast_tpu.pipeline.sdf_from_tri_verts``), up to the recompute:
    ``band_distance_field`` over the (A, K) matrices of `band`, then

    - ``"propagate"``: the plane scans; returns (their tid, parity, None);
    - ``"eikonal"``: `eikonal_iters` (default 2 * max(n)) Jacobi
      iterations outside the seeded band; returns (the band's tid, parity,
      the signed eikonal field).

    tri_verts (M, 3, 3) f32 world vertices and origin (3,) f32 tensors on
    one device; dx a float32-representable float."""
    phi0, tid0 = band_ops.band_distance_field(
        tri_verts, band["active_ids"], band["cand"], band["cand_valid"],
        origin, dx, tile_shape, tiles_dim, grid_shape, chunk=band_chunk)
    parity = _parity_device(parity_data, grid_shape[0])
    if mode == "propagate":
        _, tid, _ = sweep_ops.propagate_closest_triangles(
            phi0, tid0, tri_verts, origin, dx, max_passes=max_passes)
        return tid, parity, None
    iters = (eikonal_iters if eikonal_iters is not None
             else 2 * max(grid_shape))
    phi = sweep_ops.eikonal_far_field(phi0, tid0 >= 0, dx, iters)
    return tid0, parity, torch.where(parity, -phi, phi)


def _call_names(binned: Binned, config: SDFConfig, dense: bool):
    """(band, sign): the blob names of the band arrays and the sign arrays
    that a call with `config` reads from `binned`, after checking that it
    holds them: the band binning in the layout the route reads (none on
    the dense path), and the sign `config` asks for."""
    band = []
    if not dense:
        if tuple(binned.tile_shape) != tuple(config.tile_shape):
            raise ValueError(f"this Binned has {binned.tile_shape} tiles, "
                             f"the config {tuple(config.tile_shape)}")
        if reads_csr(config):
            if binned.band_csr is None:
                raise ValueError(
                    "this Binned holds no CSR band binning (it was made for "
                    "the dense path or another route); bin the mesh with "
                    "this config")
            band = ["ids", "pair", "off", "cnt"]
        elif binned.active_ids is None:
            raise ValueError(
                "this Binned holds no (A, K) band matrices (it was made for "
                "the dense path or another route); bin the mesh with this "
                "config")
        else:
            band = ["active_ids", "cand", "cand_valid"]
    if config.sign_mode == "device":
        if binned.sign is None:
            raise ValueError("this Binned holds no sign binning (it was made "
                             "for sign_mode='host'); bin the mesh with this "
                             "config")
        return band, list(_SIGN_NAMES)
    if binned.sign is not None:
        raise ValueError("this Binned holds the device sign's binning, not "
                         "the host parity; bin the mesh with this config")
    return band, ["parity" if binned.parity_packed is not None
                  else "crossings"]


def _device_arrays(mesh: Mesh, binned: Binned, names, device):
    """The arrays of `names` on `device`: the views of ``binned.device``
    where it lives there (no upload), else one blob packed for this call
    (with ``mesh.verts``)."""
    blob = binned.device
    if blob is not None and blob.device == device and all(
            n in blob.arrays for n in names):
        return blob.arrays
    arrays = _blob_arrays(binned, mesh.verts)
    return upload.pack_device_blob({n: arrays[n] for n in names},
                                   device).arrays


def make_level_set3(mesh: Mesh, grid: GridSpec,
                    config: SDFConfig = SDFConfig(),
                    binned: Optional[Binned] = None, *,
                    device: Union[str, torch.device],
                    verts: Optional[torch.Tensor] = None,
                    return_tid: bool = False):
    """Signed distance field of `mesh` on `grid`, computed on `device`.
    Returns a float32 (ni, nj, nk) tensor on `device` [and the int32
    closest-triangle ids if return_tid].

    `verts` ((N, 3) float32 tensor) overrides ``mesh.verts`` to obtain
    gradients; the binning is reused (valid while the vertices stay within
    their cells). The distance pipeline then runs without gradients and
    keeps only the closest-triangle ids, and phi is evaluated again from
    ``verts[tris]`` by ``ops.recompute.recompute_stage`` (kernels R1/R1b),
    so the gradient reaches `verts`. On the binned exact path this phi is
    the exact distance to each cell's triangle, tighter than the
    pyramid's. ``"propagate"`` always takes its phi from the recompute;
    ``"eikonal"`` in the seeded band only, with or without `verts`.

    With ``sign_mode="device"`` the parity is ``ops/sign.parity_field``
    on `device`, from the binning's 2D sign tiles, computed once per call
    and read by the route and the recompute alike.

    The inputs come from ``binned.device`` when it lives on `device` (its
    vertices, those of the mesh it was binned from, stand for
    ``mesh.verts``); otherwise they go up as one blob for this call
    (``upload.pack_device_blob``). Nothing here writes into them."""
    if mesh.is_empty:
        raise ValueError(
            "Cannot generate SDF from empty mesh (vertices or triangles are empty)"
        )
    device = upload.canonical(device)
    check_supported(config, len(mesh.tris))
    if binned is None:
        binned = bin_mesh(mesh, grid, config, device=device)
    with tracing.span("sdf.make_level_set3", device):
        return _level_set3(mesh, grid, config, binned, device, verts,
                           return_tid)


def _level_set3(mesh: Mesh, grid: GridSpec, config: SDFConfig,
                binned: Binned, device: torch.device, verts, return_tid):
    """:func:`make_level_set3` on `binned`, after the checks."""
    dense = use_dense(config, len(mesh.tris))
    band_names, sign_names = _call_names(binned, config, dense)
    if verts is not None:
        v = torch.as_tensor(verts, dtype=torch.float32, device=device)
        if tuple(v.shape) != tuple(mesh.verts.shape):
            raise ValueError(f"verts must have shape {mesh.verts.shape}, got "
                             f"{tuple(v.shape)}")
    d = _device_arrays(
        mesh, binned, ["tris", "origin"] + band_names + sign_names
        + ["verts"] * (verts is None), device)
    if verts is None:
        v = d["verts"]
    tris, origin = d["tris"], d["origin"]
    dx = float(np.float32(grid.dx))
    band = None if dense else {k: d[k] for k in band_names}
    if config.sign_mode == "host":
        parity = d[sign_names[0]]
    far = None
    with torch.no_grad():
        if config.sign_mode == "device":
            # computed once; the route and the recompute read this field
            sb = binned.sign
            parity = sign_ops.parity_field(
                *(d[k] for k in sign_names), sb.tile_shape, sb.tiles_dim,
                grid.shape, chunk=config.sign_chunk)
        if dense:
            phi, tid = dense_sign_core(v.detach(), tris, parity, origin, dx,
                                       grid_shape=grid.shape)
        elif config.far_field == "exact":
            phi, tid = exact_core(
                v.detach(), tris, band, parity, origin, dx,
                grid_shape=grid.shape, tiles_dim=binned.tiles_dim,
                tile_shape=binned.tile_shape,
                # the freeze threshold is capped by the band binned with
                seed_band=min(max(config.exact_band, 3), binned.seed_band),
                ladder=ladder_schedule(config, grid.shape),
                chamfer_passes=config.chamfer_passes,
                band_chunk=config.band_chunk)
        else:
            tid, parity_b, far = sweep_core(
                v.detach()[tris.long()], band, parity, origin, dx,
                mode=config.far_field,
                grid_shape=grid.shape, tile_shape=binned.tile_shape,
                tiles_dim=binned.tiles_dim, band_chunk=config.band_chunk,
                max_passes=config.max_passes,
                eikonal_iters=config.eikonal_iters)
    if verts is not None or config.far_field != "exact":
        if config.far_field == "exact":
            with tracing.span("sdf.sign", device):
                parity_b = _parity_device(parity, grid.shape[0])
        phi = recompute_ops.recompute_stage(
            v[tris.long()], tid, parity_b,
            np.asarray(grid.origin, np.float32), dx)
        if far is not None:
            phi = torch.where(tid >= 0, phi, far)
    return (phi, tid) if return_tid else phi
