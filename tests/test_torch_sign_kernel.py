"""The sign stage's one kernel (``ops/sign_kernel.parity_sign``,
``csrc/sign.cu``) and the gradient path that no longer signs, on the CPU.

- The wrapper on every parity form (packed, int16 crossings with C = 2 and
  C = 8 and sentinels at and above ni, bool), ni a multiple of 8 and not:
  decode equals the plain-torch expressions it replaced, sign is byte-equal
  to ``torch.where(parity, -phi, phi)`` (-0.0, infinities and NaN
  included), in place and not.
- A transcription of the kernel's threads (a byte row of eight cells of
  one column: the packed byte, the crossings' suffix masks, the bool
  field's bits; the sign bit flipped) against the same twins.
- A dense and a binned ``train_step`` (phi, loss, vertex gradient) and the
  generate field byte-equal to the previous path rebuilt from the kept
  helpers: the route signed, its field discarded, the parity decoded again
  for R1.
"""

import numpy as np
import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch import tracing
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.ops import band as pband
from sdfgenfast_tpu_torch.ops import recompute as prc
from sdfgenfast_tpu_torch.ops import sign_host as psh
from sdfgenfast_tpu_torch.ops import sign_kernel as psk
from sdfgenfast_tpu_torch.ops import sweep as psweep

CPU = torch.device("cpu")

torch.set_num_threads(1)

NJ, NK = 5, 7


def _field(ni, seed):
    """A seeded (ni, NJ, NK) parity field: the prefix XOR of random
    toggles."""
    rng = np.random.default_rng(seed)
    ev = rng.random((ni, NJ, NK)) < 0.2
    return np.logical_xor.accumulate(ev, axis=0)


def _crossings(parity, C):
    """(C, NJ, NK) int16 crossings of `parity`, padded with sentinels: the
    32767 of ``crossings_host`` and, in every other column, ni + 3 (any
    row at or above ni toggles nothing)."""
    ni = parity.shape[0]
    ev = parity.copy()
    ev[1:] ^= parity[:-1]
    out = np.full((C, NJ, NK), psh.CROSS_SENTINEL, np.int16)
    out[:, ::2] = ni + 3
    for j in range(NJ):
        for k in range(NK):
            rows = np.flatnonzero(ev[:, j, k])
            assert len(rows) <= C
            out[:len(rows), j, k] = rows
    return out


def _inputs(form, ni, seed=3):
    """(parity data tensor, the bool field it encodes)."""
    if form.startswith("crossings"):
        C = int(form.split("_")[1])
        rng = np.random.default_rng(seed)
        ev = np.zeros((ni, NJ, NK), bool)
        for j in range(NJ):
            for k in range(NK):
                ev[rng.choice(ni, rng.integers(0, min(C, ni) + 1),
                              replace=False), j, k] = True
        field = np.logical_xor.accumulate(ev, axis=0)
        return torch.from_numpy(_crossings(field, C)), field
    field = _field(ni, seed)
    if form == "packed":
        return torch.from_numpy(psh.pack_parity(field)), field
    return torch.from_numpy(field.copy()), field


def _phi(ni, seed=5):
    """A float32 (ni, NJ, NK) field holding +-0.0, +-inf and NaN."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((ni, NJ, NK)).astype(np.float32)
    flat = phi.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 3e38]
    flat[-2:] = [0.0, -0.0]
    return torch.from_numpy(phi)


def _bits(x):
    return x.contiguous().view(torch.int32)


FORMS = ["packed", "crossings_2", "crossings_8", "bool"]
NIS = [16, 13, 5]


def _kernel_walk(parity, ni, phi=None):
    """csrc/sign.cu's threads in NumPy: thread (b, col) builds the parity
    bits of cells 8b .. 8b + 7 of its column in one byte, then writes its
    cells (the bool field, or phi's bits with the sign bit XOR the
    parity)."""
    p = parity.numpy()
    nj, nk = p.shape[1:]
    ncols = nj * nk
    out = (np.empty((ni, ncols), np.uint8) if phi is None else
           phi.numpy().view(np.uint32).reshape(ni, ncols).copy())
    for b in range(-(-ni // 8)):
        i0 = 8 * b
        n = min(8, ni - i0)
        if p.dtype == np.uint8:
            bits = p[b].reshape(ncols).astype(np.uint32)
        elif p.dtype == np.int16:
            bits = np.zeros(ncols, np.uint32)
            for c in range(p.shape[0]):
                d = p[c].reshape(ncols).astype(np.int64) - i0
                mask = np.where(d <= 0, 0xFF, np.where(
                    d >= 8, 0, (0xFF << np.clip(d, 0, 7)) & 0xFF))
                bits ^= mask.astype(np.uint32)
        else:
            bits = np.zeros(ncols, np.uint32)
            for r in range(n):
                bits |= p[i0 + r].reshape(ncols).astype(np.uint32) << r
        for r in range(n):
            odd = (bits >> r) & 1
            if phi is None:
                out[i0 + r] = odd
            else:
                out[i0 + r] ^= (odd << 31).astype(np.uint32)
    if phi is None:
        return torch.from_numpy(out.astype(bool).reshape(ni, nj, nk))
    return torch.from_numpy(out.view(np.float32).reshape(ni, nj, nk))


@pytest.mark.parametrize("ni", NIS)
@pytest.mark.parametrize("form", FORMS)
def test_decode_equals_the_torch_expressions(form, ni):
    data, field = _inputs(form, ni)
    got = psk.parity_sign(data, ni)
    if form == "packed":
        want = psh.unpack_parity_device(data, ni)
    elif form == "bool":
        want = data
        assert got is data  # a bool field is returned as it is
    else:
        want = psh.parity_from_crossings_device(data, ni)
    assert got.dtype == torch.bool and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), field)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("ni", NIS)
@pytest.mark.parametrize("form", FORMS)
def test_sign_byte_equal_to_where(form, ni, inplace):
    data, field = _inputs(form, ni)
    phi = _phi(ni)
    keep = phi.clone()
    p = torch.from_numpy(field)
    want = torch.where(p, -keep, keep)
    got = psk.parity_sign(data, ni, phi, inplace=inplace)
    assert torch.equal(_bits(got), _bits(want))
    assert (got is phi) == inplace
    if not inplace:
        assert torch.equal(_bits(phi), _bits(keep))
    # -0.0 where odd, +0.0 where even, from a +0.0
    zero = torch.zeros_like(keep)
    signed = psk.parity_sign(data, ni, zero)
    assert torch.equal(torch.signbit(signed), p)


@pytest.mark.parametrize("ni", NIS)
@pytest.mark.parametrize("form", FORMS)
def test_kernel_walk_equals_twin(form, ni):
    data, _ = _inputs(form, ni)
    phi = _phi(ni)
    want = psk.parity_sign_reference(data, ni)
    assert torch.equal(_kernel_walk(data, ni), want)
    assert torch.equal(_bits(_kernel_walk(data, ni, phi)),
                       _bits(psk.parity_sign_reference(data, ni, phi)))


def test_kernel_walk_on_host_crossings():
    """The walk on ``crossings_host``'s transport of a real mesh (rows in
    any order the native code leaves, the sentinel) and its packed form."""
    mesh = P.icosphere(2, radius=1.0, center=(0.03, -0.02, 0.01))
    grid = P.GridSpec((-1.3,) * 3, 2.6 / 21, (21, 12, 9))
    cross = psh.crossings_host(mesh.verts, mesh.tris, grid)
    packed = psh.packed_from_crossings(cross, 21)
    want = psh.parity_field_host(mesh.verts, mesh.tris, grid)
    assert want.any() and not want.all()
    for data in (cross, packed):
        got = _kernel_walk(torch.from_numpy(data), 21)
        np.testing.assert_array_equal(got.numpy(), want)


def test_refusals():
    data, _ = _inputs("packed", 16)
    with pytest.raises(ValueError, match="rows"):
        psk.parity_sign(data[:1], 16)
    with pytest.raises(ValueError, match="rows"):
        psk.parity_sign(torch.zeros((4, NJ, NK), dtype=torch.bool), 5)
    with pytest.raises(ValueError, match="uint8"):
        psk.parity_sign(data.to(torch.int32), 16)
    with pytest.raises(ValueError, match="phi"):
        psk.parity_sign(data, 16, torch.zeros((16, NJ, NK + 1)))
    with pytest.raises(ValueError, match="phi"):
        psk.parity_sign(data, 16, torch.zeros((16, NJ, NK),
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="inplace"):
        psk.parity_sign(data, 16, inplace=True)
    with pytest.raises(ValueError, match="inplace"):
        psk.parity_sign(data, 16, torch.zeros((NK, NJ, 16)).permute(2, 1, 0),
                        inplace=True)


def test_counter_in_launch_count(monkeypatch):
    """``parity_sign.launches`` is one of ``tracing.launch_count``'s
    counters; the twin launches nothing."""
    monkeypatch.setattr(psk.parity_sign, "launches", 4)
    before = tracing.launch_count()
    data, _ = _inputs("packed", 16)
    psk.parity_sign(data, 16, _phi(16))
    assert psk.parity_sign.launches == 4
    psk.parity_sign.launches += 1
    assert tracing.launch_count() == before + 1


# -- the gradient path ----------------------------------------------------------

N = 16
GRID = P.GridSpec((-1.4,) * 3, 2.8 / N, (N,) * 3)


def _mesh(kind):
    if kind == "binned":
        return P.icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
    return P.box_mesh()


def _previous(model, verts, target, signed):
    """The previous forward and loss of `model` at `verts`: the route signs
    its field (kept, for `signed`), which the step throws away; the parity
    is decoded again for R1. Returns (phi, loss, d loss / d verts, the
    route's signed field)."""
    binned, cfg = model.binned, model.config
    d = binned.device.arrays
    parity = d["parity"] if "parity" in d else d["crossings"]
    dx = float(np.float32(GRID.dx))
    v = verts.detach().requires_grad_(True)
    with torch.no_grad():
        if binned.band_csr is None:
            route, tid = ppipe.dense_sign_core(v.detach(), d["tris"], parity,
                                               d["origin"], dx,
                                               grid_shape=GRID.shape)
        else:
            route, tid = ppipe.exact_core(
                v.detach(), d["tris"], {k: d[k] for k in ("ids", "pair",
                                                          "off", "cnt")},
                parity, d["origin"], dx, grid_shape=GRID.shape,
                tiles_dim=binned.tiles_dim, tile_shape=binned.tile_shape,
                seed_band=min(max(cfg.exact_band, 3), binned.seed_band),
                chamfer_passes=cfg.chamfer_passes)
    p = psk.parity_sign_reference(parity, GRID.shape[0])
    assert torch.equal(_bits(route), _bits(signed))
    phi = prc.recompute_stage(v[d["tris"].long()], tid, p,
                              np.asarray(GRID.origin, np.float32), dx)
    loss = torch.mean((phi - target) ** 2)
    (grad,) = torch.autograd.grad(loss, v)
    return phi.detach(), loss.detach(), grad


@pytest.mark.parametrize("kind", ["dense", "binned"])
def test_train_step_byte_equal_to_previous_path(kind):
    mesh = _mesh(kind)
    model = SDFGenerator(mesh, GRID, device="cpu")
    assert (model.binned.band_csr is None) == (kind == "dense")
    verts = model.params
    target = model.forward(verts * 0.95).detach()
    # the generate field: the route's sign in one pass
    signed = P.make_level_set3(mesh, GRID, binned=model.binned, device=CPU)
    want_phi, want_loss, want_grad = _previous(model, verts, target, signed)
    v = verts.detach().requires_grad_(True)
    phi = model.forward(v)
    loss = torch.mean((phi - target) ** 2)
    (grad,) = torch.autograd.grad(loss, v)
    assert torch.equal(_bits(phi.detach()), _bits(want_phi))
    assert torch.equal(_bits(loss), _bits(want_loss))
    assert torch.equal(_bits(grad), _bits(want_grad))
    new, step_loss = model.train_step(verts, target, lr=1e-2)
    assert torch.equal(_bits(step_loss), _bits(want_loss))
    assert torch.equal(_bits(new), _bits(
        (verts - float(np.float32(1e-2)) * want_grad).detach()))


@pytest.mark.parametrize("kind", ["dense", "binned"])
def test_route_unsigned_without_parity(kind):
    """A core given no parity returns the unsigned field; signing it in one
    pass gives the signed route bit for bit."""
    mesh = _mesh(kind)
    model = SDFGenerator(mesh, GRID, device="cpu")
    signed = P.make_level_set3(mesh, GRID, binned=model.binned, device=CPU)
    d = model.binned.device.arrays
    parity = d["parity"] if "parity" in d else d["crossings"]
    dx = float(np.float32(GRID.dx))
    if kind == "dense":
        phi, _ = ppipe.dense_sign_core(d["verts"], d["tris"], None,
                                       d["origin"], dx, grid_shape=GRID.shape)
    else:
        b = model.binned
        phi, _ = ppipe.exact_core(
            d["verts"], d["tris"], {k: d[k] for k in ("ids", "pair", "off",
                                                      "cnt")},
            None, d["origin"], dx, grid_shape=GRID.shape,
            tiles_dim=b.tiles_dim, tile_shape=b.tile_shape,
            seed_band=min(max(b.config.exact_band, 3), b.seed_band))
    assert not torch.signbit(phi).any()
    assert torch.equal(_bits(psk.parity_sign(parity, N, phi)),
                       _bits(signed))


@pytest.mark.parametrize("iters", [0, None], ids=["iters0", "default"])
def test_eikonal_field_signed_as_before(iters):
    """``sweep_core``'s eikonal field, signed in place by the kernel's
    wrapper, is bit for bit ``torch.where(parity, -phi, phi)`` of the
    unsigned field (with no iteration, phi is the band's own field)."""
    cfg = P.SDFConfig(far_field="eikonal", eikonal_iters=iters)
    mesh = _mesh("binned")
    binned = ppipe.bin_mesh(mesh, GRID, cfg, device=CPU)
    d = binned.device.arrays
    parity = d["parity"] if "parity" in d else d["crossings"]
    band = {k: d[k] for k in ("active_ids", "cand", "cand_valid")}
    tri_verts = d["verts"][d["tris"].long()]
    dx = float(np.float32(GRID.dx))
    args = dict(grid_shape=GRID.shape, tile_shape=binned.tile_shape,
                tiles_dim=binned.tiles_dim, band_chunk=cfg.band_chunk)
    tid, p, far = ppipe.sweep_core(tri_verts, band, parity, d["origin"], dx,
                                   mode="eikonal", eikonal_iters=iters,
                                   **args)
    phi0, tid0 = pband.band_distance_field(
        tri_verts, band["active_ids"], band["cand"], band["cand_valid"],
        d["origin"], dx, args["tile_shape"], args["tiles_dim"],
        GRID.shape, chunk=cfg.band_chunk)
    phi = psweep.eikonal_far_field(phi0, tid0 >= 0, dx,
                                   iters if iters is not None else 2 * N)
    want = psk.parity_sign_reference(parity, N)
    assert torch.equal(p, want) and torch.equal(tid, tid0)
    assert torch.equal(_bits(far), _bits(torch.where(want, -phi, phi)))
