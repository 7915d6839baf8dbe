"""End-to-end SDF pipeline in PyTorch: the dense and the binned exact path.

Counterpart of ``sdfgenfast_tpu/pipeline.py`` for the default
``SDFConfig()`` (``far_field="exact"``, ``sign_mode="host"``,
``parity_transport="auto"``). The path splits on the triangle count
(:func:`use_dense`), as in the JAX package.

Dense path (at most ``dense_max_tris`` triangles, :func:`dense_sign_core`):

  1. host: the x-ray parity (crossings or bit-packed), no band binning;
  2. device: vertex gather -> K1 (one kernel up to 1024 triangles): the
     exact distance of every cell to every triangle -> sign from the parity.

Binned exact path (:func:`exact_core`):

  1. host: native band binning into CSR candidate segments + x-ray parity,
     exactly the JAX package's host layer;
  2. device: K2 band kernel (exact band distances, winner ids, closest
     points) -> untile -> freeze mask;
  3. device: the coarse-to-fine closest-point pyramid, its Jacobi rounds in
     K3, run in the JAX package's axis permutation;
  4. device: K4 chamfer relaxation, then the sign from the parity.

Vertex gradients (``make_level_set3(..., verts=...)``): either path runs
without gradients and keeps only the closest-triangle ids; phi is then
evaluated again from the vertices by the recompute kernels R1/R1b
(``ops/recompute.py``).

Every step takes an explicit ``torch.device``. CUDA tensors go through the
hand-written kernels; CPU tensors through their plain-torch twins.

Not ported yet (each raises ``NotImplementedError``): ``sign_mode="device"``,
``far_field`` other than ``"exact"``, and the flat or capped jump-flood
ladder (``vdt_max_hop`` / ``vdt_extra_rounds``) and band tile shapes other
than 8^3 on the binned path.
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
from .ops import sign_host as sign_host_ops
from .ops import tiled as tiled_ops
from .ops import vdt as vdt_ops
from .ops import vdt_kernel

__all__ = ["SDFConfig", "Binned", "bin_mesh", "binned_from_arrays",
           "dense_sign_core", "exact_core", "make_level_set3", "use_dense"]

DENSE_MAX_TRIS = dense_ops.DENSE_MAX_TRIS
_DEFAULT_TILE_2D = (8, 128)  # sdfgenfast_tpu/ops/sign.py DEFAULT_TILE_2D


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """Pipeline configuration: the same fields and defaults as
    ``sdfgenfast_tpu.pipeline.SDFConfig``. Fields that only select paths
    outside this slice are accepted and checked by :func:`check_supported`."""

    exact_band: int = 1
    far_field: str = "exact"
    sign_mode: str = "host"
    parity_transport: str = "auto"
    tile_shape: Tuple[int, int, int] = band_ops.DEFAULT_TILE
    tile2d_shape: Tuple[int, int] = _DEFAULT_TILE_2D
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

    tiles_dim and band_csr are None on the dense path, which bins nothing.
    tiles_dim: (nti, ntj, ntk) 8^3-tile grid; band_csr: the K2 kernel's CSR
    layout — "pair" (P,) candidate ids (sentinel M pads), "off"/"cnt"/"ids"
    (A_pad,) per-active-tile segment starts, lengths and linear tile ids
    (sentinel T pads), "kcap" the largest segment rounded up to 64. Exactly
    one of parity_packed ((ceil(ni/8), nj, nk) uint8) and parity_crossings
    ((C, nj, nk) int16) is set. seed_band: the band the candidates were
    binned with (the freeze threshold never exceeds it).
    """

    grid: GridSpec
    config: SDFConfig
    tris: np.ndarray  # (M, 3) int32
    tiles_dim: Optional[Tuple[int, int, int]] = None
    band_csr: Optional[dict] = None
    parity_packed: Optional[np.ndarray] = None
    parity_crossings: Optional[np.ndarray] = None
    seed_band: int = 3


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


def check_supported(config: SDFConfig, num_tris: int) -> None:
    """Raise NotImplementedError for every path not ported yet."""
    if config.far_field != "exact":
        raise NotImplementedError(
            f"far_field={config.far_field!r} is not ported yet (only 'exact')")
    if config.sign_mode != "host":
        if config.sign_mode != "device":
            raise ValueError(f"unknown sign_mode: {config.sign_mode}")
        raise NotImplementedError("sign_mode='device' is not ported yet")
    if use_dense(config, num_tris):
        return  # the dense path has no ladder and no band tiles
    if config.vdt_max_hop is not None or config.vdt_extra_rounds is not None:
        raise NotImplementedError(
            "vdt_max_hop / vdt_extra_rounds (flat or capped jump-flood "
            "ladder) are not ported yet; only the default pyramid schedule")
    if tuple(config.tile_shape) != (8, 8, 8):
        raise NotImplementedError("only 8x8x8 band tiles are ported")


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


def bin_mesh(mesh: Mesh, grid: GridSpec, config: SDFConfig = SDFConfig(),
             min_cross_rows: int = 0) -> Binned:
    """Host-side preprocessing for :func:`make_level_set3` (host sign mode):
    the x-ray parity, plus band binning into the CSR layout on the binned
    path. `min_cross_rows` pads the crossings transport's row count."""
    mesh.validate_indices()
    check_supported(config, len(mesh.tris))
    packed, cross = _host_parity_choose(mesh, grid, config.parity_transport,
                                        min_cross_rows)
    if use_dense(config, len(mesh.tris)):
        return Binned(grid, config, mesh.tris.astype(np.int32),
                      parity_packed=packed, parity_crossings=cross)
    # a >=3-cell seed band makes the far field's 27-neighbourhood union
    # cover the true closest triangle for near-band cells
    seed_band = max(config.exact_band, 3)
    bb = band_ops.bin_triangles(mesh.verts, mesh.tris, grid, seed_band,
                                config.tile_shape, prune=True)
    pair, off, cnt = band_kernel.band_csr_from_binning(
        bb.cand, bb.cand_valid, int(len(mesh.tris)))
    A_pad = _bucket(bb.num_active)
    off = np.pad(off, (0, A_pad - len(off)))
    cnt = np.pad(cnt, (0, A_pad - len(cnt)))
    P_pad = _bucket(len(pair), minimum=128)
    pair = np.pad(pair, (0, P_pad - len(pair)),
                  constant_values=len(mesh.tris))
    kcap = max(-(-int(cnt.max() or 1) // 64) * 64, 64)
    ids = np.pad(bb.active_ids, (0, A_pad - bb.num_active))
    ids[bb.num_active:] = int(np.prod(bb.tiles_dim))
    csr = {"pair": pair, "off": off, "cnt": cnt, "kcap": kcap, "ids": ids}
    return Binned(grid, config, mesh.tris.astype(np.int32), bb.tiles_dim,
                  csr, packed, cross, seed_band)


def binned_from_arrays(grid: GridSpec, config: SDFConfig, *, tris,
                       tiles_dim=None, pair=None, off=None, cnt=None, ids=None,
                       kcap=None, parity_packed=None, parity_crossings=None,
                       seed_band: int = 3) -> Binned:
    """Build the port's Binned from another binning's NumPy arrays (e.g. a
    ``sdfgenfast_tpu`` Binned: ``band.active_ids``/``band_csr`` entries and
    its parity), so both packages can run from identical host state. A dense
    Binned carries the triangles and the parity only: leave every band
    array None."""
    if (parity_packed is None) == (parity_crossings is None):
        raise ValueError("give exactly one of parity_packed / parity_crossings")
    band = (tiles_dim, pair, off, cnt, ids, kcap)
    if all(v is None for v in band):
        tiles_dim = csr = None
    elif any(v is None for v in band):
        raise ValueError("give all of tiles_dim, pair, off, cnt, ids, kcap "
                         "(binned path) or none of them (dense path)")
    else:
        tiles_dim = tuple(int(v) for v in tiles_dim)
        csr = {"pair": np.asarray(pair, np.int32),
               "off": np.asarray(off, np.int32),
               "cnt": np.asarray(cnt, np.int32),
               "ids": np.asarray(ids, np.int32), "kcap": int(kcap)}
    return Binned(
        grid, config, np.asarray(tris, np.int32), tiles_dim, csr,
        None if parity_packed is None else np.asarray(parity_packed, np.uint8),
        None if parity_crossings is None
        else np.asarray(parity_crossings, np.int16),
        int(seed_band))


def _parity_device(parity_data, ni):
    """Parity for either host transport: bit-packed uint8 or int16
    crossing positions."""
    if parity_data.dtype == torch.int16:
        return sign_host_ops.parity_from_crossings_device(parity_data, ni)
    return sign_host_ops.unpack_parity_device(parity_data, ni)


def dense_sign_core(verts, tris, parity_data, origin, dx: float, *,
                    grid_shape):
    """The dense path on device tensors (``sdfgenfast_tpu.pipeline.
    _dense_sign_core``): vertex gather -> K1 -> sign from the parity.

    verts (N, 3) f32, tris (M, 3) int32, parity_data (uint8 packed or int16
    crossings), origin (3,) f32, all on one device; dx a float32-
    representable float. Returns (signed phi, tid), each (ni, nj, nk)."""
    phi, tid = dense_ops.dense_distance_field(
        verts[tris.long()], origin, dx, grid_shape=grid_shape)
    parity = _parity_device(parity_data, grid_shape[0])
    return torch.where(parity, -phi, phi), tid


def exact_core(verts, tris, band_ids, pair, tile_off, tile_cnt, parity_data,
               origin, dx: float, *, grid_shape, tiles_dim, seed_band: int,
               chamfer_passes: int = 2):
    """The binned exact pipeline on device tensors (the pyramid + kernel
    branch of ``sdfgenfast_tpu.pipeline._exact_core``).

    verts (N, 3) f32, tris (M, 3) int32, band_ids/tile_off/tile_cnt (A_pad,)
    int32, pair (P,) int32, parity_data (uint8 packed or int16 crossings),
    origin (3,) f32 tensors, all on one device; dx a float32-representable
    float. Returns (signed phi, tid), each (ni, nj, nk).
    """
    ni = grid_shape[0]
    tile_shape = (8, 8, 8)
    T = int(np.prod(tiles_dim))
    tri_local = (verts[tris.long()] - origin).reshape(-1, 9).contiguous()

    phi_r, tid_r, cpx_r, cpy_r, cpz_r = band_kernel.band_rows(
        tri_local, pair, band_ids, tile_off, tile_cnt, dx,
        tiles_dim=tiles_dim, grid_shape=grid_shape)

    def unt(rows):
        return tiled_ops.untile_rows(rows[:T], tile_shape, tiles_dim,
                                     grid_shape)

    phi0, tid0 = unt(phi_r), unt(tid_r)
    cps = (unt(cpx_r), unt(cpy_r), unt(cpz_r))
    freeze = (tid0 >= 0) & (phi0 <= float(np.float32(seed_band)
                                          * np.float32(dx)))

    # the JAX package's axis permutation (see _vdt_axis_perm)
    perm = _vdt_axis_perm(grid_shape)
    inv = tuple(int(v) for v in np.argsort(perm))

    def t(x):
        return x.permute(perm).contiguous()

    phi_p, tid_p = vdt_ops.vdt_pyramid_far_field(
        t(cps[perm[0]]), t(cps[perm[1]]), t(cps[perm[2]]), t(tid0), t(phi0),
        # extra_polish=2 is the JAX package's _exact_core default
        dx, freeze_mask=t(freeze), extra_polish=2,
        phase=vdt_kernel.round_phase)
    phi = phi_p.permute(inv).contiguous()
    tid = tid_p.permute(inv).contiguous()

    if chamfer_passes > 0:
        phi = vdt_kernel.chamfer(phi, dx, chamfer_passes)
    parity = _parity_device(parity_data, ni)
    return torch.where(parity, -phi, phi), tid


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
    their cells). The dense or binned pipeline then runs without gradients
    and keeps only the closest-triangle ids, and phi is evaluated again from
    ``verts[tris]`` by ``ops.recompute.recompute_stage`` (kernels R1/R1b),
    so the gradient reaches `verts`. On the binned path this phi is the
    exact distance to each cell's triangle, tighter than the pyramid's."""
    if mesh.is_empty:
        raise ValueError(
            "Cannot generate SDF from empty mesh (vertices or triangles are empty)"
        )
    device = torch.device(device)
    check_supported(config, len(mesh.tris))
    if binned is None:
        binned = bin_mesh(mesh, grid, config)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if verts is None:
        v = dev(mesh.verts)
    else:
        v = torch.as_tensor(verts, dtype=torch.float32, device=device)
        if tuple(v.shape) != tuple(mesh.verts.shape):
            raise ValueError(f"verts must have shape {mesh.verts.shape}, got "
                             f"{tuple(v.shape)}")
    parity = dev(binned.parity_packed if binned.parity_packed is not None
                 else binned.parity_crossings)
    tris = dev(binned.tris)
    dx = float(np.float32(grid.dx))
    origin = dev(np.asarray(grid.origin, np.float32))
    with torch.no_grad():
        if use_dense(config, len(mesh.tris)):
            phi, tid = dense_sign_core(v.detach(), tris, parity, origin, dx,
                                       grid_shape=grid.shape)
        else:
            csr = binned.band_csr
            if csr is None:
                raise ValueError(
                    "this Binned holds no band binning (it was made for the "
                    "dense path); bin the mesh with this config")
            phi, tid = exact_core(
                v.detach(), tris, dev(csr["ids"]), dev(csr["pair"]),
                dev(csr["off"]), dev(csr["cnt"]), parity, origin, dx,
                grid_shape=grid.shape, tiles_dim=binned.tiles_dim,
                # the freeze threshold is capped by the band binned with
                seed_band=min(max(config.exact_band, 3), binned.seed_band),
                chamfer_passes=config.chamfer_passes)
    if verts is not None:
        phi = recompute_ops.recompute_stage(
            v[tris.long()], tid, _parity_device(parity, grid.shape[0]),
            np.asarray(grid.origin, np.float32), dx)
    return (phi, tid) if return_tid else phi
