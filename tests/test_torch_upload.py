"""The port's transfers (``sdfgenfast_tpu_torch/upload.py``) on the CPU.

The blob is held to the JAX package's ``sdfgenfast_tpu.upload`` (its
``pack_blob_host`` is NumPy, its ``unpack_blob`` runs on JAX's CPU) on
every array set the port's ``bin_mesh`` makes; a binning uploaded at bin
time is held to the per-call blob on every route, with the upload counts
and the blob unchanged by the calls; the download (the piece cut, the
ring's schedule, strided destinations) to ``Tensor.numpy()``. Every
comparison is bit-equal."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu import upload as jax_upload
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch import upload
from sdfgenfast_tpu_torch.grid import (sizing_mode2a_proportional,
                                       sizing_python_api)
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.testing import box36

CPU = torch.device("cpu")

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _box36():
    m = box36()
    return m, sizing_mode2a_proportional(*m.bounds(), 64, 1)


def _sphere(n=32):
    m = P.icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
    return m, sizing_python_api(*m.bounds(), nx=n - 2)


def _odd_arrays():
    rng = np.random.default_rng(7)
    return {"f32": rng.random((5, 3), np.float32),
            "mask": rng.random(13) > 0.5,
            "f64": rng.random((3, 3, 3)),
            "i16": rng.integers(-9, 9, 129).astype(np.int16),
            "u8": rng.integers(0, 255, 1).astype(np.uint8),
            "i32": rng.integers(-9, 9, (7, 11)).astype(np.int32),
            "scalar": np.float32(2.5)}


def _empty_arrays():
    return {"none": np.zeros((0, 3), np.float32),
            "one": np.int32([4]),
            "none_bool": np.zeros(0, bool),
            "none_f64": np.zeros((2, 0), np.float64)}


def _binning(case):
    if case == "box36_dense_crossings":
        mesh, grid = _box36()
        b = ppipe.bin_mesh(mesh, grid)
        assert b.parity_crossings is not None and b.band_csr is None
    elif case == "sphere_csr_packed":
        mesh, grid = _sphere()
        b = ppipe.bin_mesh(mesh, grid, P.SDFConfig(
            dense_max_tris=0, parity_transport="packed"))
        assert b.parity_packed is not None and b.band_csr is not None
    elif case == "sphere_tiles":
        mesh, grid = _sphere()
        b = ppipe.bin_mesh(mesh, grid, P.SDFConfig(
            dense_max_tris=0, tile_shape=(4, 4, 16)))
        assert b.active_ids is not None and b.band_csr is None
    else:
        assert case == "sphere_device_sign"
        mesh, grid = _sphere()
        b = ppipe.bin_mesh(mesh, grid, P.SDFConfig(
            dense_max_tris=0, sign_mode="device"))
        assert b.sign.f.dtype == np.float64
    return ppipe._blob_arrays(b, mesh.verts)


ARRAY_SETS = {
    "box36_dense_crossings": lambda: _binning("box36_dense_crossings"),
    "sphere_csr_packed": lambda: _binning("sphere_csr_packed"),
    "sphere_tiles": lambda: _binning("sphere_tiles"),
    "sphere_device_sign": lambda: _binning("sphere_device_sign"),
    "odd_sizes": _odd_arrays,
    "empty_arrays": _empty_arrays,
    "empty_dict": dict,
}


@pytest.mark.parametrize("case", list(ARRAY_SETS))
def test_pack_blob_host_equals_jax(case):
    """The port's blob and metas equal JAX's byte for byte."""
    arrays = ARRAY_SETS[case]()
    blob, metas = upload.pack_blob_host(arrays)
    jblob, jmetas = jax_upload.pack_blob_host(arrays)
    assert blob.dtype == jblob.dtype == np.uint8
    np.testing.assert_array_equal(blob, jblob)
    assert metas == jmetas
    assert all(off % 128 == 0 for _, _, _, off, _, _ in metas)


@pytest.mark.parametrize("case", list(ARRAY_SETS))
def test_unpack_blob_views_equal_sources_and_jax(case):
    """Each view has its source's dtype, shape and bits, equals JAX's
    unpack_blob, and shares the blob's storage (no copy)."""
    arrays = ARRAY_SETS[case]()
    blob_np, metas = upload.pack_blob_host(arrays)
    blob = torch.from_numpy(blob_np)
    views = upload.unpack_blob(blob, metas)
    # float64 arrays (the device sign's f) need JAX's 64-bit mode
    with jax.enable_x64(True):
        jviews = {k: np.asarray(v) for k, v in jax_upload.unpack_blob(
            jnp.asarray(blob_np), metas).items()}
    assert list(views) == list(arrays) == list(jviews)
    for k, src in arrays.items():
        src = np.ascontiguousarray(src)
        got = views[k].numpy()
        assert got.dtype == src.dtype and got.shape == src.shape, k
        np.testing.assert_array_equal(got.view(np.uint8), src.view(np.uint8))
        want = jviews[k]
        assert want.dtype == got.dtype and want.shape == got.shape, k
        np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))
        assert (views[k].untyped_storage().data_ptr()
                == blob.untyped_storage().data_ptr())


def test_pack_device_blob_cpu_aliases_one_blob():
    """On the CPU the views alias the NumPy blob, one per call, and each
    call counts one upload."""
    arrays = _odd_arrays()
    before = upload.pack_device_blob.uploads
    db = upload.pack_device_blob(arrays, "cpu")
    assert upload.pack_device_blob.uploads == before + 1
    assert db.device == CPU and db.blob.dtype == torch.uint8
    want, metas = upload.pack_blob_host(arrays)
    assert db.metas == metas
    np.testing.assert_array_equal(db.blob.numpy(), want)
    lo = db.blob.data_ptr()
    for k, v in db.arrays.items():
        assert lo <= v.data_ptr() <= lo + db.blob.numel(), k
        np.testing.assert_array_equal(v.numpy(), np.ascontiguousarray(
            arrays[k]))


def test_pack_device_blob_cuda_raises_without_cuda():
    """No pageable fallback: a CUDA upload needs pinned memory and a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        upload.pack_device_blob(_odd_arrays(), "cuda:0")


def _route(name):
    if name == "dense":
        return P.box_mesh((3, 4, 5), (-1.5, -2, -2.5)), sizing_python_api(
            np.float32([-1.5, -2, -2.5]), np.float32([1.5, 2, 2.5]), nx=14), \
            P.SDFConfig()
    mesh = P.icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
    grid = sizing_python_api(*mesh.bounds(), nx=18)
    knobs = {"exact": {}, "device_sign": dict(sign_mode="device"),
             "eikonal": dict(far_field="eikonal"),
             "propagate": dict(far_field="propagate"),
             "tiles": dict(tile_shape=(4, 4, 16)),
             "capped": dict(vdt_max_hop=4)}[name]
    return mesh, grid, P.SDFConfig(dense_max_tris=0, **knobs)


ROUTES = ["dense", "exact", "device_sign", "eikonal", "propagate", "tiles",
          "capped"]


def _bits(x):
    return x.numpy().view(np.int32)


def _digest(t):
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("route", ROUTES)
def test_cached_binning_uploads_nothing(route):
    """make_level_set3 on a Binned uploaded at bin time equals the call on
    a host-only Binned (one blob packed for the call) bit for bit, phi and
    ids, and uploads nothing; the host-only Binned uploads once a call, a
    Binned on another device once too."""
    mesh, grid, cfg = _route(route)
    u = upload.pack_device_blob
    host_b = ppipe.bin_mesh(mesh, grid, cfg)
    assert host_b.device is None
    n0 = u.uploads
    dev_b = ppipe.bin_mesh(mesh, grid, cfg, device=CPU)
    assert u.uploads == n0 + 1 and dev_b.device.device == CPU
    want = ppipe.make_level_set3(mesh, grid, cfg, host_b, device=CPU,
                                 return_tid=True)
    assert u.uploads == n0 + 2
    got = ppipe.make_level_set3(mesh, grid, cfg, dev_b, device="cpu",
                                return_tid=True)
    assert u.uploads == n0 + 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # a Binned whose blob lives elsewhere: one blob for the call
    other = dataclasses.replace(dev_b, device=dataclasses.replace(
        dev_b.device, device=torch.device("meta")))
    again = ppipe.make_level_set3(mesh, grid, cfg, other, device=CPU)
    assert u.uploads == n0 + 3
    np.testing.assert_array_equal(_bits(again), _bits(want[0]))
    # with no Binned, bin_mesh uploads once
    ppipe.make_level_set3(mesh, grid, cfg, device=CPU)
    assert u.uploads == n0 + 4


@pytest.mark.parametrize("route", ROUTES)
def test_cached_binning_survives_calls(route):
    """No route writes into its inputs: two calls on one uploaded Binned
    (the second with a vertex gradient) give bit-equal fields and leave
    the blob's digest unchanged."""
    mesh, grid, cfg = _route(route)
    b = ppipe.bin_mesh(mesh, grid, cfg, device=CPU)
    digest = _digest(b.device.blob)
    first = ppipe.make_level_set3(mesh, grid, cfg, b, device=CPU)
    second = ppipe.make_level_set3(mesh, grid, cfg, b, device=CPU)
    np.testing.assert_array_equal(_bits(first), _bits(second))
    verts = torch.from_numpy(mesh.verts.copy()).requires_grad_(True)
    phi = ppipe.make_level_set3(mesh, grid, cfg, b, device=CPU, verts=verts)
    phi.sum().backward()
    assert verts.grad is not None
    assert _digest(b.device.blob) == digest


def test_binned_from_arrays_uploads_once():
    """A binning carried over by binned_from_arrays is host-only and
    uploads once a call; with its arrays and the vertices uploaded as one
    blob (as bin_mesh(device=) does) it uploads once, and the calls
    nothing, bit-equal to bin_mesh's."""
    mesh, grid, cfg = _route("exact")
    b = ppipe.bin_mesh(mesh, grid, cfg)
    csr = b.band_csr
    carried = ppipe.binned_from_arrays(
        grid, cfg, tris=b.tris, tiles_dim=b.tiles_dim, pair=csr["pair"],
        off=csr["off"], cnt=csr["cnt"], ids=csr["ids"], kcap=csr["kcap"],
        parity_packed=b.parity_packed, parity_crossings=b.parity_crossings,
        seed_band=b.seed_band)
    assert carried.device is None
    n0 = upload.pack_device_blob.uploads
    want = ppipe.make_level_set3(mesh, grid, cfg, b, device=CPU)
    cached = ppipe._uploaded(carried, mesh.verts, CPU)
    assert upload.pack_device_blob.uploads == n0 + 2
    got = ppipe.make_level_set3(mesh, grid, cfg, cached, device=CPU)
    assert upload.pack_device_blob.uploads == n0 + 2
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("route", ["dense", "exact"])
def test_train_steps_upload_nothing(route):
    """SDFGenerator uploads at refresh; three train_steps then upload
    nothing, and commit uploads once (its rebinning)."""
    mesh, grid, cfg = _route(route)
    u = upload.pack_device_blob
    n0 = u.uploads
    model = SDFGenerator(mesh, grid, cfg, device=CPU)
    assert u.uploads == n0 + 1
    v = model.params
    assert u.uploads == n0 + 2
    with torch.no_grad():
        target = model.forward(v * 0.97)
    losses = []
    for _ in range(3):
        v, loss = model.train_step(v, target, lr=1e-2)
        losses.append(float(loss))
    assert u.uploads == n0 + 2 and np.isfinite(losses).all()
    model.commit(v)
    assert u.uploads == n0 + 3
    np.testing.assert_array_equal(model.mesh.verts, v.numpy())


def _download_cases():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 10, 12), generator=g)
    return {
        "n0": (torch.zeros((0, 4)), upload.CHUNK_BYTES),
        "n0_last": (torch.zeros((3, 0)), 16),
        "scalar": (torch.tensor(2.5), 4),
        "below_one_chunk": (x, upload.CHUNK_BYTES),
        "ragged_1d": (torch.arange(1001, dtype=torch.int32), 36),
        "ragged_planes": (x, 4 * 10 * 12 * 4 + 100),
        "ragged_rows": (x, 4 * 12 * 3 + 8),
        "element_pieces": (x[:2, :3], 8),
        "noncontiguous": (x[:, ::3, 1:].transpose(0, 2), 52),
        "bool": (x > 0, 7),
        "float64": (x.double()[1:4], 64),
    }


@pytest.mark.parametrize("case", list(_download_cases()))
def test_to_host_equals_numpy(case, monkeypatch):
    """to_host and to_host_async equal Tensor.numpy() (dtype, shape and
    bits) for empty tensors, one piece, ragged last pieces (a small
    CHUNK_BYTES) and non-contiguous inputs."""
    t, chunk = _download_cases()[case]
    monkeypatch.setattr(upload, "CHUNK_BYTES", chunk)
    want = t.numpy().copy()
    for got in (upload.to_host(t), upload.to_host_async(t).result()):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))
        assert got.flags.c_contiguous
        assert not np.shares_memory(got, t.numpy())


@pytest.mark.parametrize("shape,itemsize,limit", [
    ((1001,), 4, 36), ((6, 10, 12), 4, 500), ((6, 10, 12), 4, 4 * 12 * 3),
    ((6, 10, 12), 4, 8), ((3, 5, 7, 2), 8, 8 * 7 * 2 * 2 + 3), ((), 4, 4),
    ((4, 4), 1, 1 << 20)])
def test_pieces_cover_every_byte_once(shape, itemsize, limit):
    """The pieces are at most `limit` bytes, tile the source's bytes in
    order, and each index selects a view of exactly its bytes."""
    pieces = upload._pieces(shape, itemsize, limit)
    total = int(np.prod(shape)) * itemsize
    end = 0
    dst = np.empty(shape, np.dtype(f"V{itemsize}"))
    for index, off, n in pieces:
        assert off == end and 0 < n <= limit
        assert dst[index].size * itemsize == n
        end = off + n
    assert end == total


@pytest.mark.parametrize("slots,slot_bytes", [(1, 48), (2, 40), (3, 36),
                                              (4, 4096)])
def test_ring_schedule(slots, slot_bytes):
    """The ring's schedule on the CPU (pageable slots standing in for the
    pinned ones): every piece fetched ahead, waited for, written into a
    strided block of a larger array, the last piece ragged."""
    x = torch.arange(7 * 5 * 9, dtype=torch.float32).reshape(7, 5, 9)
    big = np.full((7, 11, 13), -1, np.float32)
    out = big[:, 3:8, 2:11]
    pieces = upload._pieces(x.shape, 4, slot_bytes)
    ring = [torch.empty(slot_bytes, dtype=torch.uint8) for _ in range(slots)]
    upload._staged(x.reshape(-1).view(torch.uint8), pieces, out, ring)
    np.testing.assert_array_equal(out, x.numpy())
    outside = np.ones(big.shape, bool)
    outside[:, 3:8, 2:11] = False
    assert (big[outside] == -1).all()


def test_to_host_into_block_of_a_grid(monkeypatch):
    """out= writes each block into its slice of one grid, as the one-process
    sharded batch assembles its shards."""
    monkeypatch.setattr(upload, "CHUNK_BYTES", 40)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6, 8), generator=g)
    grid = np.empty((4, 12, 16), np.float32)
    copies = [upload.to_host_async(x[:, :3, :4] + a + 2 * c, out=grid[
        :, a * 6:(a + 1) * 6, c * 8:(c + 1) * 8][:, :3, :4])
        for a in range(2) for c in range(2)]
    for copy in copies:
        copy.result()
    for a in range(2):
        for c in range(2):
            np.testing.assert_array_equal(
                grid[:, a * 6:a * 6 + 3, c * 8:c * 8 + 4],
                (x[:, :3, :4] + a + 2 * c).numpy())


def test_to_host_rejects_bad_arguments():
    t = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="out"):
        upload.to_host(t, out=np.empty((4, 3), np.float32))
    with pytest.raises(ValueError, match="out"):
        upload.to_host(t, out=np.empty((3, 4), np.float64))
    read_only = np.empty((3, 4), np.float32)
    read_only.flags.writeable = False
    with pytest.raises(ValueError, match="out"):
        upload.to_host_async(t, out=read_only)
    assert upload.pinned_bytes() in (0, upload.RING_SLOTS * upload.CHUNK_BYTES)


def test_batch_equals_single_calls_one_upload_a_mesh():
    """generate_sdf_batch equals per-mesh generate_sdf (dense and binned
    meshes) and uploads once a mesh."""
    box = P.box_mesh((3, 4, 5), (-1.5, -2, -2.5))
    sphere = P.icosphere(3, radius=1.8)
    meshes = [(m.verts, m.tris) for m in (box, sphere, box)]
    args = ((-2.5, -3.0, -3.5), 0.25, 21, 25, 29)
    n0 = upload.pack_device_blob.uploads
    got = P.generate_sdf_batch(meshes, *args, backend="cpu")
    assert upload.pack_device_blob.uploads == n0 + len(meshes)
    for (v, t), g in zip(meshes, got):
        want = P.generate_sdf(v, t, *args, backend="cpu")
        np.testing.assert_array_equal(g.view(np.int32), want.view(np.int32))
