"""Multi-GPU SDF pipeline: grid-tile sharding over a (j, k) mesh of
devices, the shards in one process (``multihost.py`` runs the same stages
with the shards spread over several processes).

Counterpart of ``sdfgenfast_tpu/parallel/sharded.py``. The grid is cut into
(Dj, Dk) blocks of (ni, nj / Dj, nk / Dk) cells; shard (dj, dk) owns one
block and runs on ``device_mesh.devices[dj, dk]``. There is no
``shard_map``: each stage is a plain loop over the shards, each shard's
work under its own device, and a halo exchange is a copy of the
neighbours' boundary planes to the receiving shard's device. Devices may
repeat (``["cuda:0"] * 4``: one card runs the shards one after another;
``["cpu"] * 8`` in the tests).

The decomposition is the JAX package's:

- the i axis is not cut, so the x-ray parity is local to every shard (host
  parity packed per block, or ``ops/sign.parity_field`` on the shard's own
  rays with its (j, k) offset);
- the band and sign binnings are global, on the host, and their active
  tiles are split by owner shard (tiles never straddle a block edge), so
  every shard runs the single-device kernels: K2 with shard-local rows but
  global coordinate ids (``band_kernel.band_rows(coord_ids=...)``), the
  tile evaluator with ``ijk_offset`` / ``upper_override``, K1 and R1/R1b
  with ``ijk_offset``, all with the global grid's upper bound;
- the far field, by default the pyramid (:func:`_sharded_pyramid`): local
  downsamples (block offsets are even, so the local pairing is the
  global one), the coarsest level gathered on every shard and its whole
  ladder run there (strides above 8 by ``vdt._jacobi_round``, the rest by
  K3), then the descent's repair rounds through K3 on halo-extended blocks
  with their global position offset; with ``vdt_max_hop`` the capped
  ladder, every round K3 on a halo-extended block
  (``vdt.vdt_far_field(halo_extend=...)``);
- the chamfer: one ``passes``-deep exchange, K4 on the extended block, the
  block cut back out (:func:`_sharded_chamfer`);
- ``far_field="eikonal"``: ``band_distance_field`` with the block's offset
  and the global upper bound, then the Jacobi iterations over all blocks
  in lockstep (``sweep.eikonal_far_field(halo_extend=...)``, one-cell
  halos on j and on k an iteration), the band recomputed by R1;
- ``far_field="propagate"``: the same band, then the plane scans
  (:func:`_sharded_propagate`): along i every shard advances plane by
  plane with a corner-complete one-cell halo of the previous planes;
  along j or k one shard row a round, its last plane carried to the next
  row; a pass ends in one OR over the shards; phi from R1 on the ids;
- vertex gradients: each shard gathers ``verts.to(its device)``, so
  autograd sums the shards' gradients on ``verts``' device.

Every exchange between shards goes through a transport: a
:class:`LocalTransport` when this process owns every shard (copies with
``.to(device)``), ``multihost.DistributedTransport`` when several
processes share the mesh (``DeviceMesh.ranks``).

Every step equals the single-device run's cell for cell, so a sharded run
equals ``pipeline.make_level_set3`` bit for bit wherever the single-device
pyramid's axis permutation (``pipeline._vdt_axis_perm``) is the identity
(k the largest axis): the sharded pyramid always runs unpermuted.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..grid import GridSpec
from ..mesh import Mesh as TriMesh
from ..ops import band as band_ops
from ..ops import band_kernel
from ..ops import dense as dense_ops
from ..ops import recompute as recompute_ops
from ..ops import sign as sign_ops
from ..ops import sign_host as sign_host_ops
from ..ops import sweep as sweep_ops
from ..ops import vdt as vdt_ops
from ..ops import vdt_kernel
from ..pipeline import (SDFConfig, _band_k2, _band_tiles, check_supported,
                        reads_csr, use_dense)
from ..platform import require_cuda

__all__ = ["DeviceMesh", "make_device_mesh", "ShardedBinned",
           "bin_mesh_sharded", "sharded_sdf", "sharded_fields",
           "LocalTransport", "spans_processes", "halo_comms_model"]


def halo_comms_model(grid_shape, dims, max_hop=None, extra_rounds=None,
                     chamfer_passes=2):
    """Exact per-round halo traffic of the sharded far field, per shard
    (``sdfgenfast_tpu.parallel.sharded.halo_comms_model``, the same dict).

    `max_hop=None` models the default pyramid: nothing for the local
    downsamples, one two-phase gather of the coarsest state, then each
    descent level's repair rounds (stride <= 8), each exchanging one
    corner-complete s-deep halo in two phases (j-planes of the
    (5, ni_l, nj_l, nk_l) level state, then k-planes of the j-extended
    block). An integer max_hop models the capped ladder: one max_hop-capped
    slab a round, the same two-phase way. Each phase sends both directions.
    The chamfer exchanges one `passes`-deep halo. `ppermute_calls` keeps
    the JAX name: the number of two-sided plane exchanges."""
    ni, nj, nk = grid_shape
    Dj, Dk = dims
    nj_l, nk_l = nj // Dj, nk // Dk
    f32 = 4
    rounds = []
    gathers = []
    if max_hop is None:
        lshapes = vdt_ops.pyramid_level_shapes(grid_shape)
        L = len(lshapes)
        ni_c, nj_c, nk_c = lshapes[-1]
        state_c = 5 * f32 * ni_c * (nj_c // Dj) * (nk_c // Dk)
        gathers.append({"phase": "all_gather_j",
                        "bytes": int(state_c * (Dj - 1))})
        gathers.append({"phase": "all_gather_k",
                        "bytes": int(state_c * Dj * (Dk - 1) // 1)})
        for lvl in range(L - 2, -1, -1):
            ni_lvl, njl, nkl = (lshapes[lvl][0],
                                nj_l >> lvl, nk_l >> lvl)
            sched = (vdt_ops.PYRAMID_COARSE_ROUNDS if lvl > 0
                     else tuple(vdt_ops.PYRAMID_LEVEL_ROUNDS) + (1, 1))
            for s_ in sched:
                j_bytes = 2 * 5 * f32 * ni_lvl * s_ * nkl
                k_bytes = 2 * 5 * f32 * ni_lvl * (njl + 2 * s_) * s_
                rounds.append({"level": lvl, "stride": int(s_),
                               "halo_bytes": j_bytes + k_bytes})
    else:
        if extra_rounds is None:
            extra_rounds = 2 if max(grid_shape) <= 256 else 4
        strides = vdt_ops.stride_ladder(
            max(grid_shape), max_hop=max_hop, extra_rounds=extra_rounds)
        for s_ in strides:
            j_bytes = 2 * 5 * f32 * ni * s_ * nk_l
            k_bytes = 2 * 5 * f32 * ni * (nj_l + 2 * s_) * s_
            rounds.append({"stride": int(s_),
                           "halo_bytes": j_bytes + k_bytes})
    p = chamfer_passes
    cham_bytes = (2 * f32 * ni * p * nk_l
                  + 2 * f32 * ni * (nj_l + 2 * p) * p)
    return {
        "grid": list(grid_shape),
        "device_mesh": [Dj, Dk],
        "schedule": "pyramid" if max_hop is None else "capped_ladder",
        "max_hop": None if max_hop is None else int(max_hop),
        "vdt_rounds": len(rounds),
        "rounds": rounds,
        "coarse_gathers": gathers,
        "vdt_total_bytes_per_device": int(
            sum(r["halo_bytes"] for r in rounds)
            + sum(g["bytes"] for g in gathers)),
        "chamfer_bytes_per_device": int(cham_bytes),
        "ppermute_calls": 2 * len(rounds) + 2,
    }


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (Dj, Dk) mesh of torch devices over the grid's j and k axes:
    shard (dj, dk) owns j-block dj and k-block dk of the grid. ``devices``
    is a (Dj, Dk) object array of ``torch.device``, which may repeat;
    ``ranks`` (``multihost.global_device_mesh``) the (Dj, Dk) int array of
    the process that owns each shard, None when one process owns all."""

    devices: np.ndarray
    ranks: Optional[np.ndarray] = None


def make_device_mesh(devices=None, shape: Optional[Tuple[int, int]] = None
                     ) -> DeviceMesh:
    """A (j, k) device mesh over `devices` (anything ``torch.device``
    takes; default: every visible CUDA device); shape defaults to the most
    square factoring."""
    if devices is None:
        require_cuda()
        devices = range(torch.cuda.device_count())
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a device mesh needs at least one device")
    if shape is None:
        dj = int(np.sqrt(n))
        while n % dj:
            dj -= 1
        shape = (dj, n // dj)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(tuple(int(v) for v in shape)))


def check_device_mesh(device_mesh) -> Tuple[int, int]:
    """The (Dj, Dk) of a :class:`DeviceMesh`; TypeError for anything else."""
    devices = getattr(device_mesh, "devices", None)
    if (not isinstance(devices, np.ndarray) or devices.ndim != 2
            or not all(isinstance(d, torch.device) for d in devices.flat)):
        raise TypeError("device_mesh must be a DeviceMesh "
                        "(parallel.make_device_mesh)")
    ranks = getattr(device_mesh, "ranks", None)
    if ranks is not None and (not isinstance(ranks, np.ndarray)
                              or ranks.shape != devices.shape
                              or ranks.dtype.kind not in "iu"):
        raise TypeError("DeviceMesh.ranks must be an int array of the "
                        "devices' shape")
    return tuple(int(v) for v in devices.shape)


# ---------------------------------------------------------------------------
# Host-side partitioned binning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBinned:
    """Global binning partitioned by owner shard (NumPy).

    Band arrays have shape (Dj, Dk, A, K): active ids are LOCAL linear tile
    ids within each shard's block (the local tile count for pad rows, which
    are dropped), band_gids the same tiles' GLOBAL ids (the global count
    for pad rows). The CSR (8^3 tiles, ``far_field="exact"``) is per shard,
    padded to common sizes. The device sign's 2D tiles are partitioned the
    same way; `f` and `window` are the global :class:`ops.sign.SignBinning`
    arrays, on every shard (the JAX package's double-float split
    ``f_hi``/``f_lo`` is not kept: the card has float64)."""

    grid: GridSpec
    config: SDFConfig
    dims: Tuple[int, int]  # (Dj, Dk)
    block: Tuple[int, int, int]  # local (ni, nj_l, nk_l)
    band_tiles_local: Tuple[int, int, int]
    band_ids: np.ndarray
    band_cand: np.ndarray
    band_valid: np.ndarray
    parity_packed: np.ndarray  # (Dj, Dk, ceil(ni/8), nj_l, nk_l) uint8
    tris: np.ndarray
    csr_pair: Optional[np.ndarray] = None   # (Dj, Dk, P_pad) int32
    csr_off: Optional[np.ndarray] = None    # (Dj, Dk, A) int32
    csr_cnt: Optional[np.ndarray] = None    # (Dj, Dk, A) int32
    band_gids: Optional[np.ndarray] = None  # (Dj, Dk, A) int32
    band_tiles_global: Optional[Tuple[int, int, int]] = None
    kcap: int = 0
    sign_ids: Optional[np.ndarray] = None    # (Dj, Dk, A2) int32
    sign_cand: Optional[np.ndarray] = None   # (Dj, Dk, A2, K2) int32
    sign_valid: Optional[np.ndarray] = None  # (Dj, Dk, A2, K2) bool
    f: Optional[np.ndarray] = None           # (M, 3, 3) float64
    window: Optional[np.ndarray] = None      # (M, 4) int32
    sign_tiles_local: Optional[Tuple[int, int]] = None


def _partition_tiles(active_ids, cand, valid, tiles_dim, tiles_local, dims):
    """Split global active tiles by owner shard; renumber ids locally."""
    if len(tiles_dim) == 3:
        nti, ntj, ntk = tiles_dim
        lti, ltj, ltk = tiles_local
        ti = active_ids // (ntj * ntk)
        tj = (active_ids // ntk) % ntj
        tk = active_ids % ntk
        dj = tj // ltj
        dk = tk // ltk
        local = (ti * ltj + (tj % ltj)) * ltk + (tk % ltk)
        local_total = lti * ltj * ltk
    else:
        ntj, ntk = tiles_dim
        ltj, ltk = tiles_local
        tj = active_ids // ntk
        tk = active_ids % ntk
        dj = tj // ltj
        dk = tk // ltk
        local = (tj % ltj) * ltk + (tk % ltk)
        local_total = ltj * ltk
    Dj, Dk = dims
    owner = (dj * Dk + dk).astype(np.int64)
    counts = np.bincount(owner, minlength=Dj * Dk)
    A = max(int(counts.max()), 1)
    A = -(-A // 8) * 8
    K = cand.shape[1]
    global_total = int(np.prod(tiles_dim))
    ids_out = np.full((Dj * Dk, A), local_total, np.int32)
    gids_out = np.full((Dj * Dk, A), global_total, np.int32)
    cand_out = np.zeros((Dj * Dk, A, K), np.int32)
    valid_out = np.zeros((Dj * Dk, A, K), bool)
    order = np.argsort(owner, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(owner)) - offs[owner[order]]
    ids_out[owner[order], pos] = local[order].astype(np.int32)
    gids_out[owner[order], pos] = active_ids[order].astype(np.int32)
    cand_out[owner[order], pos] = cand[order]
    valid_out[owner[order], pos] = valid[order]
    return (
        ids_out.reshape(Dj, Dk, A),
        cand_out.reshape(Dj, Dk, A, K),
        valid_out.reshape(Dj, Dk, A, K),
        gids_out.reshape(Dj, Dk, A),
    )


def bin_mesh_sharded(mesh: TriMesh, grid: GridSpec, dims: Tuple[int, int],
                     config: SDFConfig = SDFConfig()) -> ShardedBinned:
    """The host binning of ``sdfgenfast_tpu.parallel.bin_mesh_sharded``,
    bit for bit: the global band binning (seed band and prune policy of
    ``pipeline.bin_mesh``) split by owner shard, per-shard CSR at 8^3
    tiles in ``"exact"`` mode, and the sign: the host parity packed per
    shard block, or (``sign_mode="device"``) the 2D sign tiles split by
    owner shard. ValueError where the blocks do not divide. One
    ``sdf.sharded.bin`` host span, the ``sdf.bin.*`` ranges inside."""
    with tracing.span("sdf.sharded.bin"):
        return _bin_sharded(mesh, grid, dims, config)


def _bin_sharded(mesh: TriMesh, grid: GridSpec, dims: Tuple[int, int],
                 config: SDFConfig) -> ShardedBinned:
    """:func:`bin_mesh_sharded` inside its span."""
    Dj, Dk = (int(v) for v in dims)
    ni, nj, nk = grid.shape
    if nj % Dj or nk % Dk:
        raise ValueError(f"grid (nj={nj}, nk={nk}) must divide over device "
                         f"mesh {tuple(dims)}")
    nj_l, nk_l = nj // Dj, nk // Dk
    tile_shape = tuple(int(v) for v in config.tile_shape)
    ti, tj, tk = tile_shape
    if nj_l % tj or nk_l % tk:
        raise ValueError("shard block must be a multiple of tile_shape")
    mesh.validate_indices()
    check_supported(config, len(mesh.tris))
    csr = {}
    tiles_global = None
    if use_dense(config, len(mesh.tris)):
        band_tiles_local = (1, 1, 1)
        b_ids = np.zeros((Dj, Dk, 0), np.int32)
        b_cand = np.zeros((Dj, Dk, 0, 1), np.int32)
        b_valid = np.zeros((Dj, Dk, 0, 1), bool)
        b_gids = np.zeros((Dj, Dk, 0), np.int32)
    else:
        exact = config.far_field == "exact"
        seed_band = (max(config.exact_band, 3) if exact
                     else config.exact_band)
        with tracing.span("sdf.bin.band", ranged=True):
            bb = band_ops.bin_triangles(mesh.verts, mesh.tris, grid,
                                        seed_band, tile_shape, prune=exact)
            nti = -(-ni // ti)
            band_tiles_local = (nti, nj_l // tj, nk_l // tk)
            tiles_global = tuple(int(x) for x in bb.tiles_dim)
            b_ids, b_cand, b_valid, b_gids = _partition_tiles(
                bb.active_ids.astype(np.int64), bb.cand, bb.cand_valid,
                bb.tiles_dim, band_tiles_local, (Dj, Dk))
        if reads_csr(config):
            with tracing.span("sdf.bin.csr", ranged=True):
                csr = _shard_csr(b_cand, b_valid, len(mesh.tris))

    sign_kw = {}
    if config.sign_mode == "device":
        tj2, tk2 = (int(v) for v in config.tile2d_shape)
        if nj_l % tj2 or nk_l % tk2:
            raise ValueError(
                f"sign_mode='device' needs shard blocks divisible by "
                f"tile2d_shape {tuple(config.tile2d_shape)} "
                f"(got nj_l={nj_l}, nk_l={nk_l})")
        with tracing.span("sdf.bin.parity", ranged=True):
            sb = sign_ops.bin_triangles_2d(mesh.verts, mesh.tris, grid,
                                           (tj2, tk2))
            sign_tiles_local = (nj_l // tj2, nk_l // tk2)
            s_ids, s_cand, s_valid, _ = _partition_tiles(
                sb.active_ids.astype(np.int64), sb.cand, sb.cand_valid,
                sb.tiles_dim, sign_tiles_local, (Dj, Dk))
        packed_blocks = np.zeros((Dj, Dk, 0, nj_l, nk_l), np.uint8)
        sign_kw = dict(sign_ids=s_ids, sign_cand=s_cand, sign_valid=s_valid,
                       f=sb.f, window=sb.window,
                       sign_tiles_local=sign_tiles_local)
    else:
        with tracing.span("sdf.bin.parity", ranged=True):
            packed = sign_host_ops.parity_packed_host(mesh.verts, mesh.tris,
                                                      grid)
            packed_blocks = (packed.reshape(packed.shape[0], Dj, nj_l, Dk,
                                            nk_l)
                             .transpose(1, 3, 0, 2, 4).copy())

    return ShardedBinned(
        grid, config, (Dj, Dk), (ni, nj_l, nk_l),
        band_tiles_local, b_ids, b_cand, b_valid,
        packed_blocks, mesh.tris.astype(np.int32),
        csr_pair=csr.get("pair"), csr_off=csr.get("off"),
        csr_cnt=csr.get("cnt"), band_gids=b_gids,
        band_tiles_global=tiles_global, kcap=csr.get("kcap", 0),
        **sign_kw,
    )


def _shard_csr(b_cand: np.ndarray, b_valid: np.ndarray, num_tris: int):
    """Per-shard CSR arrays for K2 (``band_kernel.band_csr_from_binning``),
    padded to common sizes across shards, as the JAX package pads them."""
    Dj, Dk, A, _K = b_cand.shape
    pairs, offs, cnts = [], [], []
    for dj in range(Dj):
        for dk in range(Dk):
            p, o, c = band_kernel.band_csr_from_binning(
                b_cand[dj, dk], b_valid[dj, dk], num_tris)
            pairs.append(p)
            offs.append(o)
            cnts.append(c)
    P = max(len(p) for p in pairs)
    P_pad = max(-(-P // 128) * 128, 128)
    pair_out = np.full((Dj * Dk, P_pad), num_tris, np.int32)
    off_out = np.zeros((Dj * Dk, A), np.int32)
    cnt_out = np.zeros((Dj * Dk, A), np.int32)
    kcap = 64
    for s, (p, o, c) in enumerate(zip(pairs, offs, cnts)):
        pair_out[s, :len(p)] = p
        off_out[s, :len(o)] = o
        cnt_out[s, :len(c)] = c
        kcap = max(kcap, -(-int(c.max() or 1) // 64) * 64)
    return {
        "pair": pair_out.reshape(Dj, Dk, P_pad),
        "off": off_out.reshape(Dj, Dk, A),
        "cnt": cnt_out.reshape(Dj, Dk, A),
        "kcap": int(kcap),
    }


# ---------------------------------------------------------------------------
# Shards and their transport (a "grid" is a list of Dj lists of Dk blocks;
# a block that another process owns is None)
# ---------------------------------------------------------------------------


def _on(device):
    """The context a shard's work runs in: its CUDA device, if it has one."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _neighbour(dj: int, dk: int, axis_name: str, step: int, dims):
    """The (dj, dk) of a shard's neighbour `step` blocks away along the
    mesh axis `axis_name`, or None beyond the mesh."""
    a, b = (dj + step, dk) if axis_name == "j" else (dj, dk + step)
    return (a, b) if 0 <= a < dims[0] and 0 <= b < dims[1] else None


def _halo_plane(x, axis: int, depth: int, step: int):
    """The `depth` planes of block `x` that a block `step` away from it
    along `axis` reads as its halo: x's last planes when x is that block's
    lo neighbour (step -1), its first when the hi one (step 1)."""
    size = x.shape[axis]
    return x.narrow(axis, size - depth if step < 0 else 0, depth)


class LocalTransport:
    """How the shards of a mesh reach each other when one process owns
    them all: a neighbour's planes, the whole of a level and a carried
    plane are copies to the receiving block's device (``.to(device)``).
    ``parallel.multihost.DistributedTransport`` does the same between
    processes. `devices` is the mesh's (Dj, Dk) array; `mine` marks the
    shards this process owns (here every one)."""

    def __init__(self, devices):
        self.devices = devices
        self.mine = np.ones(devices.shape, bool)

    def each(self, fn):
        """[[fn(dj, dk) for dk] for dj] over this process's shards (None
        elsewhere), each call under its shard's device."""
        Dj, Dk = self.devices.shape
        out = []
        for dj in range(Dj):
            row = []
            for dk in range(Dk):
                if self.mine[dj, dk]:
                    with _on(self.devices[dj, dk]):
                        row.append(fn(dj, dk))
                else:
                    row.append(None)
            out.append(row)
        return out

    def flat(self, grid):
        """This process's blocks of `grid`, row-major."""
        return [x for row in grid for x in row if x is not None]

    def unflat(self, items):
        """The inverse of :meth:`flat`: a grid with None where another
        process owns the shard."""
        it = iter(items)
        return [[next(it) if m else None for m in row] for row in self.mine]

    def _remote_halos(self, grid, axis_name, axis, depth):
        """{(dj, dk, step): planes} received from other processes: none
        here."""
        return {}

    def extend(self, grid, axis_name: str, axis: int, fill, depth: int = 1):
        """Each block of `grid` with `depth` planes of its lo and hi
        neighbours along the mesh axis `axis_name` ("j" or "k")
        concatenated on tensor axis `axis`: the lo neighbour's last planes,
        the hi neighbour's first ones; `fill` at the mesh's edges
        (``sdfgenfast_tpu.parallel.sharded._extend``). `grid` may be a
        row or a column of the mesh (the plane scans' rounds).

        One ``sdf.sharded.halo`` range a call, whose count ``bytes`` is
        what the extension writes: each extended block, each fill, and each
        neighbour's planes that another device or process sent (a plane on
        the receiving block's own device is read where it lies)."""
        with tracing.span("sdf.sharded.halo", ranged=True) as sp:
            out, written = self._extend(grid, axis_name, axis, fill, depth)
            if sp is not None:
                sp.add("bytes", written)
            return out

    def _extend(self, grid, axis_name: str, axis: int, fill, depth: int):
        """:meth:`extend`'s grid and the bytes it wrote."""
        dims = (len(grid), len(grid[0]))
        remote = self._remote_halos(grid, axis_name, axis, depth)
        out = []
        written = 0
        for dj in range(dims[0]):
            row = []
            for dk in range(dims[1]):
                x = grid[dj][dk]
                if x is None:
                    row.append(None)
                    continue
                if depth > x.shape[axis]:
                    raise ValueError(f"halo of {depth} cells on a block of "
                                     f"{x.shape[axis]} along {axis_name}")
                halo_shape = list(x.shape)
                halo_shape[axis] = depth
                halo_bytes = x.numel() // x.shape[axis] * depth \
                    * x.element_size()
                halos = []
                for step in (-1, 1):
                    nb = _neighbour(dj, dk, axis_name, step, dims)
                    if nb is None:
                        halos.append(torch.full(halo_shape, fill,
                                                dtype=x.dtype,
                                                device=x.device))
                        written += halo_bytes
                    elif (dj, dk, step) in remote:
                        halos.append(remote[dj, dk, step].to(x.device))
                        written += halo_bytes
                    else:
                        plane = _halo_plane(grid[nb[0]][nb[1]], axis, depth,
                                            step)
                        halos.append(plane.to(x.device))
                        if plane.device != x.device:
                            written += halo_bytes
                row.append(torch.cat([halos[0], x, halos[1]], dim=axis))
                written += row[-1].numel() * row[-1].element_size()
            out.append(row)
        return out, written

    def gather(self, grid, axis: int, device):
        """The whole grid of blocks on `device`: the blocks concatenated
        along tensor axis `axis` in j, then along `axis` + 1 in k."""
        Dj, Dk = len(grid), len(grid[0])
        return torch.cat([torch.cat([grid[a][b].to(device) for a in range(Dj)],
                                    dim=axis) for b in range(Dk)],
                         dim=axis + 1)

    def any(self, flags) -> bool:
        """True where any shard's 0-d bool tensor in the grid `flags` is:
        one host sync."""
        dev = self.devices.flat[0]
        return bool(torch.stack([f.to(dev) for f in self.flat(flags)]).any())

    def carry(self, plane, device):
        """A plane scan's last plane, to the next shard row's device."""
        return plane.to(device)


def spans_processes(device_mesh) -> bool:
    """True when another process owns some of the mesh's shards."""
    ranks = getattr(device_mesh, "ranks", None)
    return ranks is not None and len(np.unique(ranks)) > 1


def _state_halo_extend(tr, grid, s: int):
    """Corner-complete s-deep halos on the sharded j and k axes of
    channel-first (5, ni, nj_l, nk_l) states: j first, then k of the
    j-extended blocks (so the corners come from the diagonal neighbours);
    FAR beyond the grid."""
    ext = tr.extend(grid, "j", 2, float(vdt_ops.FAR), depth=s)
    return tr.extend(ext, "k", 3, float(vdt_ops.FAR), depth=s)


def _sharded_chamfer(tr, phi, dx: float, passes: int):
    """The chamfer with corner-complete cross-shard halos: one
    `passes`-deep exchange (3e38 beyond the grid), every pass on the
    extended block (K4 on CUDA), the block cut back out. Ring by ring the
    block's cells see what the pass sequence over the whole grid gives
    them, so each equals ``vdt_kernel.chamfer`` on the whole grid bit for
    bit."""
    p = int(passes)
    ext = tr.extend(tr.extend(phi, "j", 1, vdt_ops._BIG, depth=p), "k", 2,
                    vdt_ops._BIG, depth=p)

    def run(dj, dk):
        _, nje, nke = ext[dj][dk].shape
        out = vdt_kernel.chamfer(ext[dj][dk], dx, p)
        return out[:, p:nje - p, p:nke - p].contiguous()

    return tr.each(run)


def _sharded_pyramid(tr, seeds, dx: float, j_offs, k_offs, gdims,
                     extra_polish: int = 2):
    """The coarse-to-fine closest-point far field over the shards: the
    single-device schedule (``vdt.vdt_pyramid_far_field`` with
    ``extra_polish`` = 2, unpermuted) with local downsamples, the coarsest
    level gathered on every shard (``torch.cat`` in j, then in k) and its
    whole ladder run there, and the descent's repair rounds on
    halo-extended blocks. `seeds[dj][dk]` = (cpx, cpy, cpz, tid0, phi0,
    freeze); j_offs[dj] / k_offs[dk] the blocks' global offsets. Returns
    the grid of (phi, tid)."""
    phase = vdt_kernel.round_phase
    lshapes = vdt_ops.pyramid_level_shapes(gdims)
    L = len(lshapes)
    devices = tr.devices

    def offs(dj, dk, lvl):
        return (0, j_offs[dj] >> lvl, k_offs[dk] >> lvl)

    levels = [tr.each(lambda dj, dk: vdt_ops.seed_state(
        *seeds[dj][dk][:4], dx, offs(dj, dk, 0)))]
    for lvl in range(1, L):
        prev = levels[-1]
        levels.append(tr.each(lambda dj, dk: vdt_ops._downsample2(
            prev[dj][dk], dx, 1 << (lvl - 1), offs(dj, dk, lvl - 1))))

    coarse, scale_c = levels[-1], 1 << (L - 1)
    ladder = vdt_ops.stride_ladder(max(lshapes[-1]), extra_rounds=1)

    def coarse_ladder(dj, dk):
        full = tr.gather(coarse, 2, devices[dj, dk])
        pos = vdt_ops._level_pos_axes(full.shape[1:], dx, scale_c,
                                      devices[dj, dk])
        for st in ladder:
            if st > 8:
                full = vdt_ops._jacobi_round(full, *pos, st)
        full = phase(full, dx, [st for st in ladder if st <= 8], scale_c)
        _, _, nj_c, nk_c = coarse[dj][dk].shape
        _, jc, kc = offs(dj, dk, L - 1)
        return full[:, :, jc:jc + nj_c, kc:kc + nk_c].contiguous()

    state = tr.each(coarse_ladder)
    for lvl in range(L - 2, -1, -1):
        fine, scale = levels[lvl], 1 << lvl
        parents = state
        state = tr.each(lambda dj, dk: vdt_ops._upsample_merge(
            parents[dj][dk], fine[dj][dk], *vdt_ops._level_pos_axes(
                fine[dj][dk].shape[1:], dx, scale, devices[dj, dk],
                offs(dj, dk, lvl))))
        rounds = (vdt_ops.PYRAMID_COARSE_ROUNDS if lvl > 0
                  else vdt_ops.PYRAMID_LEVEL_ROUNDS + (1,) * extra_polish)
        for st in rounds:
            ext = _state_halo_extend(tr, state, st)
            state = tr.each(lambda dj, dk: vdt_ops._halo_round(
                ext[dj][dk], dx, st, scale, offs(dj, dk, lvl), phase))

    return tr.each(lambda dj, dk: vdt_ops.finish_state(
        state[dj][dk], seeds[dj][dk][3], seeds[dj][dk][4], seeds[dj][dk][5]))


# ---------------------------------------------------------------------------
# The sharded plane scans (far_field="propagate"; one process)
# ---------------------------------------------------------------------------


def _scan_i(tr, phi, tid, tri_verts, pos_axes, reverse: bool):
    """A plane scan along the unsharded i axis: every shard advances plane
    by plane in lockstep, and each step's candidates come from the previous
    plane of every shard extended corner-complete by one cell (j, then k of
    the j-extended planes; -1 beyond the grid)."""
    out_phi = tr.each(lambda dj, dk: sweep_ops.scan_copy(phi[dj][dk], 0))
    out_tid = tr.each(lambda dj, dk: sweep_ops.scan_copy(tid[dj][dk], 0))
    geo = tr.each(lambda dj, dk: sweep_ops.plane_geometry(pos_axes[dj][dk],
                                                          0))
    order = sweep_ops.scan_order(tr.flat(out_phi)[0].shape[0], reverse)
    prev = tr.each(lambda dj, dk: out_tid[dj][dk][order[0]])
    for a in order[1:]:
        ext = tr.extend(tr.extend(prev, "j", 0, -1), "k", 1, -1)

        def step(dj, dk):
            gx0, plane_pos = geo[dj][dk]
            new_phi, new_tid = sweep_ops.plane_update(
                sweep_ops.shift_stack(ext[dj][dk]), out_phi[dj][dk][a],
                out_tid[dj][dk][a], tri_verts[dj][dk],
                (gx0 + plane_pos[a])[None])
            out_phi[dj][dk][a] = new_phi
            out_tid[dj][dk][a] = new_tid
            return new_tid

        prev = tr.each(step)
    return out_phi, out_tid


def _scan_sharded(tr, phi, tid, tri_verts, pos_axes, axis: int,
                  reverse: bool):
    """A plane scan along the sharded axis 1 (j) or 2 (k): one round a
    shard row (column), in scan order. The active row's shards scan in
    lockstep; each step's candidates come from their previous (ni, C)
    planes padded by -1 on i and extended along the other sharded axis.
    The first round keeps the scan's first plane; every later round updates
    every plane of its blocks from the carry, the last plane of the
    previous round's block moved to the next row's device."""
    devices = tr.devices
    Dj, Dk = devices.shape
    out_phi = tr.each(lambda dj, dk: sweep_ops.scan_copy(phi[dj][dk], axis))
    out_tid = tr.each(lambda dj, dk: sweep_ops.scan_copy(tid[dj][dk], axis))
    geo = tr.each(lambda dj, dk: sweep_ops.plane_geometry(pos_axes[dj][dk],
                                                          axis))
    other = "k" if axis == 1 else "j"
    carry = None
    for r, row in enumerate(sweep_ops.scan_order(Dj if axis == 1 else Dk,
                                                 reverse)):
        members = ([(row, c) for c in range(Dk)] if axis == 1
                   else [(c, row) for c in range(Dj)])
        order = sweep_ops.scan_order(out_phi[row][0].shape[0] if axis == 1
                                     else out_phi[0][row].shape[0], reverse)
        if r == 0:
            prev = [out_tid[m][n][order[0]] for m, n in members]
            planes = order[1:]
        else:
            prev = [tr.carry(p, devices[m, n])
                    for p, (m, n) in zip(carry, members)]
            planes = order
        for a in planes:
            padded = [F.pad(p[None], (0, 0, 1, 1), value=-1)[0] for p in prev]
            ext = tr.flat(tr.extend([padded] if axis == 1
                                    else [[p] for p in padded],
                                    other, 1, -1))
            new = []
            for (m, n), e in zip(members, ext):
                with _on(devices[m, n]):
                    gx0, plane_pos = geo[m][n]
                    new_phi, new_tid = sweep_ops.plane_update(
                        sweep_ops.shift_stack(e), out_phi[m][n][a],
                        out_tid[m][n][a], tri_verts[m][n],
                        (gx0 + plane_pos[a])[None])
                    out_phi[m][n][a] = new_phi
                    out_tid[m][n][a] = new_tid
                new.append(new_tid)
            prev = new
        carry = prev
    return tuple(tr.each(lambda dj, dk: g[dj][dk].movedim(0, axis)
                         .contiguous()) for g in (out_phi, out_tid))


def _sharded_propagate(tr, phi, tid, tri_verts, pos_axes, max_passes: int):
    """``far_field="propagate"`` over the shards
    (``sdfgenfast_tpu.parallel.sharded._sharded_propagate``): the
    single-device passes of six plane scans (:func:`_scan_i`,
    :func:`_scan_sharded`) until a pass changes no shard's phi (one host
    sync a pass) or `max_passes` ran. Every plane update is the
    single-device one on the same candidates, so phi, ids and the pass
    count equal ``ops/sweep.propagate_closest_triangles``'s. `pos_axes`
    gives each block's global (i, j, k) position tables. Returns (phi grid,
    tid grid, passes)."""
    passes = 0
    while passes < max_passes:
        phi0 = phi
        for axis in (0, 1, 2):
            for reverse in (False, True):
                if axis == 0:
                    phi, tid = _scan_i(tr, phi, tid, tri_verts, pos_axes,
                                       reverse)
                else:
                    phi, tid = _scan_sharded(tr, phi, tid, tri_verts,
                                             pos_axes, axis, reverse)
        passes += 1
        if not tr.any(tr.each(lambda dj, dk: (phi[dj][dk]
                                              != phi0[dj][dk]).any())):
            break
    return phi, tid, passes


def _upload(a, device):
    """A host array on `device`: one ``sdf.sharded.upload`` range."""
    with tracing.span("sdf.sharded.upload", ranged=True):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _shard_band(binned: ShardedBinned, dj: int, dk: int, tri_verts, origin,
                dx: float, ijk_offset, gdims):
    """The shard's band, (phi0, tid0, (cpx, cpy, cpz)), by the pipeline's
    band steps: K2 with coordinate ids at 8^3 tiles, else the tile
    evaluator with the block's offset; the global grid's upper bound in
    both."""
    dev = tri_verts.device
    kw = dict(grid_shape=binned.block, tiles_dim=binned.band_tiles_local)
    ids = _upload(binned.band_ids[dj, dk], dev)
    if binned.csr_pair is not None:
        band = {"ids": ids, "pair": _upload(binned.csr_pair[dj, dk], dev),
                "off": _upload(binned.csr_off[dj, dk], dev),
                "cnt": _upload(binned.csr_cnt[dj, dk], dev)}
        return _band_k2(tri_verts - origin, band, dx,
                        coord_ids=_upload(binned.band_gids[dj, dk], dev),
                        coord_tiles_dim=binned.band_tiles_global,
                        coord_grid_shape=gdims, **kw)
    band = {"active_ids": ids, "cand": _upload(binned.band_cand[dj, dk], dev),
            "cand_valid": _upload(binned.band_valid[dj, dk], dev)}
    return _band_tiles(tri_verts, band, origin, dx,
                       tile_shape=tuple(int(v) for v in
                                        binned.config.tile_shape),
                       chunk=binned.config.band_chunk, ijk_offset=ijk_offset,
                       upper=band_kernel._upper(gdims, dx), **kw)


def _shard_parity(binned: ShardedBinned, dj: int, dk: int, device, jk_offset):
    """The shard's (ni, nj_l, nk_l) parity: the host parity's packed block,
    or the device sign on the shard's own rays (``parity_field`` with its
    (j, k) offset)."""
    ni = binned.block[0]
    if binned.sign_ids is None:
        return sign_host_ops.unpack_parity_device(
            _upload(binned.parity_packed[dj, dk], device), ni)
    cfg = binned.config
    return sign_ops.parity_field(
        _upload(binned.f, device), _upload(binned.window, device),
        _upload(binned.sign_ids[dj, dk], device),
        _upload(binned.sign_cand[dj, dk], device),
        _upload(binned.sign_valid[dj, dk], device),
        tuple(int(v) for v in cfg.tile2d_shape), binned.sign_tiles_local,
        binned.block, chunk=cfg.sign_chunk, jk_offset=jk_offset)


def _shard_sweep_band(binned: ShardedBinned, dj: int, dk: int, tri_verts,
                      origin, dx: float, ijk_offset, gdims):
    """The shard's band of the sweep modes, (phi0, tid0): the
    single-device ``band_distance_field`` over its unpruned candidates,
    with the block's offset and the global grid's upper bound."""
    dev = tri_verts.device
    cfg = binned.config
    return band_ops.band_distance_field(
        tri_verts, _upload(binned.band_ids[dj, dk], dev),
        _upload(binned.band_cand[dj, dk], dev),
        _upload(binned.band_valid[dj, dk], dev), origin, dx,
        tuple(int(v) for v in cfg.tile_shape), binned.band_tiles_local,
        binned.block, chunk=cfg.band_chunk, ijk_offset=ijk_offset,
        upper_override=band_kernel._upper(gdims, dx))


def sharded_sdf(binned: ShardedBinned, device_mesh: DeviceMesh, verts=None,
                assemble: bool = True, return_tid: bool = False):
    """Run the sharded pipeline on `device_mesh` (whose shape must be the
    binning's `dims`), every shard in this process.

    `verts` ((N, 3): NumPy, or a float32 tensor, for gradients one that
    requires grad) is needed: the binning keeps only the triangles. With a
    gradient each shard evaluates phi again from ``verts.to(its device)``
    by R1/R1b with its offset, as ``make_level_set3(verts=...)`` does;
    otherwise the sign is applied to the far field's phi (``"propagate"``
    always takes phi from R1, ``"eikonal"`` in the seeded band). Returns the
    (ni, nj, nk) field on the first shard's device if `assemble`, else the
    (Dj, Dk) grid (a list of lists) of (ni, nj_l, nk_l) blocks, each on its
    shard's device; with `return_tid`, a pair: that and the int32
    closest-triangle ids that the recompute reads, in the same form. A
    mesh whose shards live in several processes runs through
    ``parallel.multihost.sharded_sdf_multihost``."""
    check_device_mesh(device_mesh)
    if spans_processes(device_mesh):
        raise ValueError("this device mesh spans processes: run it through "
                         "parallel.multihost.sharded_sdf_multihost")
    tr = LocalTransport(device_mesh.devices)
    out, tids = sharded_fields(binned, device_mesh, verts, tr)
    if assemble:
        dev0 = device_mesh.devices[0, 0]
        out, tids = (tr.gather(g, 1, dev0) for g in (out, tids))
    return (out, tids) if return_tid else out


def sharded_fields(binned: ShardedBinned, device_mesh: DeviceMesh, verts,
                   tr):
    """The sharded pipeline over the shards that `tr` (a
    :class:`LocalTransport` or ``multihost.DistributedTransport``) owns:
    (signed phi grid, id grid), None where another process owns a shard
    (see :func:`sharded_sdf`).

    One ``sdf.sharded.fields`` host span (the host's enqueueing of every
    shard), and in it one ``sdf.sharded.card`` device span a device: from
    a marker on its stream before the device's first launch to one after
    its last."""
    with tracing.span("sdf.sharded.fields"):
        cards = [tracing.begin("sdf.sharded.card", device=d)
                 for d in dict.fromkeys(tr.devices[tr.mine])]
        out = _fields(binned, device_mesh, verts, tr)
        for card in cards:
            if card is not None:
                card.end()
        return out


def _fields(binned: ShardedBinned, device_mesh: DeviceMesh, verts, tr):
    """:func:`sharded_fields` inside its spans."""
    cfg = binned.config
    if cfg.far_field not in ("exact", "eikonal", "propagate"):
        raise ValueError(f"unknown far_field mode: {cfg.far_field}")
    dims = check_device_mesh(device_mesh)
    if dims != tuple(binned.dims):
        raise ValueError(f"device mesh {dims} != the binning's {binned.dims}")
    if verts is None:
        raise ValueError("sharded_sdf needs `verts` (ShardedBinned stores "
                         "only tris)")
    dense = use_dense(cfg, len(binned.tris))
    sweep = not dense and cfg.far_field != "exact"
    ni, nj_l, nk_l = binned.block
    Dj, Dk = dims
    gdims = (ni, nj_l * Dj, nk_l * Dk)
    pyramid = cfg.vdt_max_hop is None and cfg.vdt_extra_rounds is None
    strides = ()
    if not dense and not sweep and pyramid:
        _validate_pyramid_blocks(gdims, binned.block, dims)
    elif not dense and not sweep:
        cap = cfg.vdt_max_hop
        if cap is None or cap > min(nj_l, nk_l):
            raise ValueError(
                "the capped-ladder sharded mode (config.vdt_extra_rounds "
                "set) needs config.vdt_max_hop <= the shard block on the "
                f"sharded axes (min(nj_l, nk_l) = {min(nj_l, nk_l)}); a "
                "single-device run with the same vdt_max_hop matches "
                "bit-exactly")
        extra = cfg.vdt_extra_rounds
        if extra is None:
            extra = 2 if max(gdims) <= 256 else 4
        strides = vdt_ops.stride_ladder(max(gdims), max_hop=cap,
                                        extra_rounds=extra)

    grad = torch.is_tensor(verts) and verts.requires_grad
    if not torch.is_tensor(verts):
        verts = torch.from_numpy(np.asarray(verts, np.float32))
    elif verts.dtype != torch.float32:
        raise ValueError(f"verts must be float32, got {verts.dtype}")
    devices = device_mesh.devices
    dx = float(np.float32(binned.grid.dx))
    origin32 = np.asarray(binned.grid.origin, np.float32)
    j_offs = [dj * nj_l for dj in range(Dj)]
    k_offs = [dk * nk_l for dk in range(Dk)]

    def ijk(dj, dk):
        return (0, j_offs[dj], k_offs[dk])

    def shard_inputs(dj, dk):
        dev = devices[dj, dk]
        tv = verts.to(dev)[_upload(binned.tris, dev).long()]
        return tv, _upload(origin32, dev)

    inputs = tr.each(shard_inputs)
    far = None
    with torch.no_grad():
        if dense:
            fields = tr.each(lambda dj, dk: dense_ops.dense_distance_field(
                inputs[dj][dk][0].detach(), inputs[dj][dk][1], dx,
                grid_shape=binned.block, ijk_offset=ijk(dj, dk)))
        elif sweep:
            bands = tr.each(lambda dj, dk: _shard_sweep_band(
                binned, dj, dk, inputs[dj][dk][0].detach(),
                inputs[dj][dk][1], dx, ijk(dj, dk), gdims))
            if cfg.far_field == "propagate":
                pos = tr.each(lambda dj, dk: tuple(
                    torch.arange(o, o + n, device=devices[dj, dk]).to(
                        torch.float32) * dx + inputs[dj][dk][1][a]
                    for a, (o, n) in enumerate(zip(ijk(dj, dk),
                                                   binned.block))))
                phis, tids, _ = _sharded_propagate(
                    tr, _part(bands, 0), _part(bands, 1),
                    tr.each(lambda dj, dk: inputs[dj][dk][0].detach()), pos,
                    cfg.max_passes)
                fields = _zip(phis, tids)
            else:
                iters = (cfg.eikonal_iters if cfg.eikonal_iters is not None
                         else 2 * max(gdims))
                far = tr.unflat(sweep_ops.eikonal_far_field(
                    [b[0] for b in tr.flat(bands)],
                    [b[1] >= 0 for b in tr.flat(bands)], dx, iters,
                    halo_extend=lambda phis, axis: tr.flat(tr.extend(
                        tr.unflat(phis), "jk"[axis - 1], axis,
                        float("inf")))))
                fields = bands
        else:
            seed_band = max(cfg.exact_band, 3)
            thresh = float(np.float32(seed_band) * np.float32(dx))

            def band(dj, dk):
                tv, origin = inputs[dj][dk]
                phi0, tid0, cps = _shard_band(binned, dj, dk, tv.detach(),
                                              origin, dx, ijk(dj, dk), gdims)
                return (*cps, tid0, phi0, (tid0 >= 0) & (phi0 <= thresh))

            seeds = tr.each(band)
            if pyramid:
                fields = _sharded_pyramid(tr, seeds, dx, j_offs, k_offs,
                                          gdims)
            else:
                cols = list(zip(*tr.flat(seeds)))
                fields = tr.unflat(vdt_ops.vdt_far_field(
                    *cols[:5], dx, strides, freeze_mask=cols[5],
                    phase=vdt_kernel.round_phase,
                    ijk_offset=[ijk(dj, dk) for dj, dk in np.ndindex(dims)
                                if tr.mine[dj, dk]],
                    halo_extend=lambda states, s: tr.flat(_state_halo_extend(
                        tr, tr.unflat(states), s))))
            if cfg.chamfer_passes > 0:
                phis = _sharded_chamfer(tr, _part(fields, 0), dx,
                                        cfg.chamfer_passes)
                fields = _zip(phis, _part(fields, 1))
        parity = tr.each(lambda dj, dk: _shard_parity(
            binned, dj, dk, devices[dj, dk], (j_offs[dj], k_offs[dk])))

    def signed(dj, dk):
        phi, tid = fields[dj][dk]
        if not grad and not sweep:
            return torch.where(parity[dj][dk], -phi, phi)
        out = recompute_ops.recompute_stage(
            inputs[dj][dk][0], tid, parity[dj][dk], origin32, dx,
            ijk_offset=ijk(dj, dk), grid_shape=gdims)
        if far is not None:
            # eikonal: the band from R1, the far field the signed estimate
            out = torch.where(tid >= 0, out, torch.where(
                parity[dj][dk], -far[dj][dk], far[dj][dk]))
        return out

    return tr.each(signed), _part(fields, 1)


def _part(grid, i: int):
    """Item `i` of each block's tuple in `grid` (None stays None)."""
    return [[None if x is None else x[i] for x in row] for row in grid]


def _zip(*grids):
    """The grid of tuples of the blocks of `grids` (None where theirs
    are)."""
    return [[None if xs[0] is None else xs for xs in zip(*rows)]
            for rows in zip(*grids)]


def _validate_pyramid_blocks(gdims, block, dims):
    """The pyramid's halo repair rounds (stride <= 8) need each level's
    local block to cover the halo depth on any axis that is actually
    sharded. Blocks are tile-8 multiples, so this only bites tiny blocks on
    deep pyramids."""
    L = len(vdt_ops.pyramid_level_shapes(gdims))
    if L == 1:
        # a one-level pyramid: the whole state is gathered and the ladder
        # runs on every shard, no halo rounds, so any block size works
        return
    _, nj_l, nk_l = block
    Dj, Dk = dims
    need = 8 << (L - 2)
    if (Dj > 1 and nj_l < need) or (Dk > 1 and nk_l < need):
        raise ValueError(
            f"sharded pyramid far field needs shard blocks >= {need} cells "
            f"on sharded axes for this grid (got nj_l={nj_l}, nk_l={nk_l}); "
            "use fewer devices on that axis, or set config.vdt_max_hop for "
            "the capped-ladder schedule"
        )
