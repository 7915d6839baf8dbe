"""Transfers between the host and the device: a binning's arrays go up as
one blob, and every result comes back through pinned staging.

Counterpart of ``sdfgenfast_tpu/upload.py``, written for a CUDA card.

**Up.** :func:`pack_blob_host` lays a dict of NumPy arrays out as one uint8
blob, byte for byte as the JAX package does: each array at a 128-byte
aligned offset, bool sent as uint8, and the metas tuple ``(name,
dtype.str, shape, offset, nbytes, was_bool)``. :func:`pack_device_blob`
writes that blob into pinned host memory and copies it to the device with
one non-blocking copy on the current stream, and :func:`unpack_blob` hands
each array back as a typed view of the device blob: no copy, no launch. The
alignment is what makes every ``view(dtype)`` legal. ``pipeline.bin_mesh
(device=...)`` uploads once per binning and keeps the views in
``Binned.device``, so later calls on that binning upload nothing. The
pinned blob belongs to torch's caching host allocator, which hands its
memory out again only after the copy has completed.

**Down.** :func:`to_host` and :func:`to_host_async` return a tensor as an
ordinary NumPy array (the counterpart of ``np.asarray`` and
``copy_to_host_async``). A CPU tensor is a plain copy. A CUDA tensor is
copied on a side stream, after an event on the producing stream, through a
ring of ``RING_SLOTS`` pinned staging slots of ``CHUNK_BYTES``: the tensor
is cut into pieces of at most one slot (:func:`_pieces`), ``RING_SLOTS``
pieces cross the link ahead, and piece c is written into the result while
pieces c+1 ... c+RING_SLOTS-1 are still crossing. The ring is the only
pinned memory this module holds: ``RING_SLOTS * CHUNK_BYTES`` = 64 MiB,
allocated at the first download, for the life of the process
(:func:`pinned_bytes`).

**Threads.** The calling thread records the producing stream's event,
takes the snapshot (``to_host_async`` only: the source is cloned on the
producing stream, so that the caller may write into or free it at once)
and allocates the result. One worker thread, started at the first CUDA
download, owns the ring: it enqueues every staging copy on the side stream,
waits for each, and writes the pieces into the results, one download after
another. Its waits and its copies into the result release the interpreter
lock, so the calling thread bins the next mesh meanwhile.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["CHUNK_BYTES", "RING_SLOTS", "DeviceBlob", "Download",
           "canonical", "pack_blob_host", "pack_device_blob", "pinned_bytes",
           "to_host", "to_host_async", "unpack_blob"]

_ALIGN = 128
CHUNK_BYTES = 16 << 20
RING_SLOTS = 4


def canonical(device) -> torch.device:
    """`device` as a torch.device with its index: "cuda" is the current
    CUDA device, so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _layout(arrays: dict):
    """(the arrays' bytes, metas, blob size): the layout of
    ``sdfgenfast_tpu.upload.pack_blob_host``."""
    parts, metas, off = [], [], 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        was_bool = a.dtype == np.bool_
        if was_bool:
            a = a.astype(np.uint8)
        flat = a.view(np.uint8).ravel()
        metas.append((k, a.dtype.str, a.shape, off, len(flat), was_bool))
        parts.append(flat)
        off += len(flat) + (-len(flat)) % _ALIGN
    return parts, tuple(metas), off


def _fill(dst: np.ndarray, parts, metas) -> None:
    """Write the arrays' bytes at their offsets and zeros in the padding."""
    end = 0
    for flat, (_, _, _, off, n, _) in zip(parts, metas):
        dst[end:off] = 0
        dst[off:off + n] = flat
        end = off + n
    dst[end:] = 0


def pack_blob_host(arrays: dict):
    """Concatenate a dict of NumPy arrays into (blob uint8, metas tuple),
    equal to ``sdfgenfast_tpu.upload.pack_blob_host`` byte for byte."""
    parts, metas, n = _layout(arrays)
    blob = np.empty(n, np.uint8)
    _fill(blob, parts, metas)
    return blob, metas


def _torch_dtype(dstr: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dstr)).dtype


def unpack_blob(blob: torch.Tensor, metas) -> dict:
    """The typed arrays of a uint8 blob tensor as views of it (bool ones by
    ``view(torch.bool)``): no copy, no launch."""
    out = {}
    for k, dstr, shape, off, n, was_bool in metas:
        piece = blob[off:off + n]
        piece = piece.view(torch.bool if was_bool else _torch_dtype(dstr))
        out[k] = piece.view(shape)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceBlob:
    """One uploaded blob: its `device`, the uint8 `blob` tensor, its
    `metas` and the typed views of its `arrays` (:func:`unpack_blob`)."""

    device: torch.device
    blob: torch.Tensor
    metas: tuple
    arrays: dict


def _pinned_blob(arrays: dict):
    """(blob, metas) as :func:`pack_blob_host` makes them, the blob a
    pinned uint8 tensor from torch's caching host allocator. A failed
    pinned allocation raises: nothing falls back to pageable memory."""
    parts, metas, n = _layout(arrays)
    staging = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    _fill(staging.numpy(), parts, metas)
    return staging, metas


def pack_device_blob(arrays: dict, device) -> DeviceBlob:
    """Upload a dict of NumPy arrays to `device` as one blob.

    For a CUDA device the blob is written into pinned host memory and
    copied with one ``copy_(non_blocking=True)`` on the current stream: the
    host does not wait, and work queued after it on that stream reads the
    views. For the CPU the views alias the NumPy blob. Every call adds one
    to ``pack_device_blob.uploads``."""
    device = canonical(device)
    if device.type == "cpu":
        host, metas = pack_blob_host(arrays)
        blob = torch.from_numpy(host)
    else:
        staging, metas = _pinned_blob(arrays)
        blob = torch.empty(staging.numel(), dtype=torch.uint8, device=device)
        blob.copy_(staging, non_blocking=True)
    pack_device_blob.uploads += 1
    return DeviceBlob(device, blob, metas, unpack_blob(blob, metas))


pack_device_blob.uploads = 0


# -- down ---------------------------------------------------------------------


def _pieces(shape, itemsize: int, limit: int):
    """The C-order array of `shape` cut into pieces of at most `limit`
    bytes: [(index, byte offset, bytes)], each piece contiguous in the
    source and ``out[index]`` its view in any destination of that shape
    (whole slices of the first dimension whose slice fits, else each of
    its indices cut the same way one dimension down)."""
    if 0 in shape:
        return []
    if not shape:
        return [((Ellipsis,), 0, itemsize)]
    strides = [itemsize] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    out = []

    def walk(prefix, off, d):
        step = strides[d]
        if step > limit and d + 1 < len(shape):
            for i in range(shape[d]):
                walk(prefix + (i,), off + i * step, d + 1)
            return
        g = limit // step
        for a in range(0, shape[d], g):
            b = min(a + g, shape[d])
            out.append((prefix + (slice(a, b),), off + a * step,
                        (b - a) * step))

    walk((), 0, 0)
    return out


def _write(out: np.ndarray, index, piece: torch.Tensor) -> None:
    """Write one piece (uint8 CPU tensor) into its view of `out`."""
    dst = out[index]
    torch.from_numpy(dst).copy_(
        piece.view(_torch_dtype(out.dtype.str)).view(dst.shape))


def _staged(src: torch.Tensor, pieces, out: np.ndarray, slots,
            stream=None) -> None:
    """The ring's schedule: pieces 0 .. R-1 are fetched into the R `slots`;
    then piece c is waited for and written into `out`, and piece c+R is
    fetched into its slot. `src` is the source's bytes (uint8, flat).
    With a CUDA `src` this runs on the worker thread under
    ``torch.cuda.stream(stream)``, the side stream, and waits on an event
    per fetch; the tests run it on the CPU."""
    R = len(slots)
    events = [None] * R

    def fetch(c):
        _, off, n = pieces[c]
        slots[c % R][:n].copy_(src[off:off + n], non_blocking=True)
        if stream is not None:
            events[c % R] = stream.record_event()

    for c in range(min(R, len(pieces))):
        fetch(c)
    for c, (index, _, n) in enumerate(pieces):
        if stream is not None:
            events[c % R].synchronize()
        _write(out, index, slots[c % R][:n])
        if c + R < len(pieces):
            fetch(c + R)


class _Stager:
    """The process's download machinery: one worker thread, the pinned
    ring (created by the worker, touched by nothing else) and a side stream
    per device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool = None
        self._streams = {}
        self.slots = None

    def side_stream(self, device) -> torch.cuda.Stream:
        with self._lock:
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device=device)
            return self._streams[device]

    def submit(self, fn) -> concurrent.futures.Future:
        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="sdfgen-to-host")
            return self._pool.submit(fn)

    def run(self, src, ready, pieces, out, stream) -> None:
        """A download on the worker thread."""
        if self.slots is None:
            self.slots = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                      pin_memory=True)
                          for _ in range(RING_SLOTS)]
        with torch.cuda.device(src.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            try:
                _staged(src, pieces, out, self.slots, stream)
            finally:
                # nothing still in flight into a slot the next download
                # takes, even after a failure
                stream.synchronize()


_STAGER = _Stager()


def pinned_bytes() -> int:
    """Pinned host memory this module holds: the ring once a CUDA
    download has run (``RING_SLOTS * CHUNK_BYTES``), else 0."""
    slots = _STAGER.slots
    return 0 if slots is None else sum(s.numel() for s in slots)


class Download:
    """A copy to the host that may still be running: :meth:`result` waits
    for it and returns the NumPy array (and raises what the copy raised)."""

    def __init__(self, array: np.ndarray,
                 future: Optional[concurrent.futures.Future] = None):
        self._array = array
        self._future = future

    def result(self) -> np.ndarray:
        if self._future is not None:
            self._future.result()
        return self._array


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _start(t: torch.Tensor, out, snapshot: bool) -> Download:
    t = t.detach()
    shape = tuple(t.shape)
    dtype = _numpy_dtype(t.dtype)
    if out is None:
        out = np.empty(shape, dtype)
    elif (out.shape != shape or out.dtype != dtype
          or not out.flags.writeable):
        raise ValueError(f"out must be a writable {dtype} array of shape "
                         f"{shape}, got {out.dtype} {out.shape}")
    pieces = _pieces(shape, t.element_size(), CHUNK_BYTES)
    if not pieces:
        return Download(out)
    if t.device.type != "cuda":
        src = t.contiguous().reshape(-1).view(torch.uint8)
        for index, off, n in pieces:
            _write(out, index, src[off:off + n])
        return Download(out)
    # on the producing stream: a contiguous source (a copy of `t` if the
    # caller gets control back before the copy ends), then the event the
    # side stream waits for. The worker's reference keeps `src` alive until
    # _Stager.run has synchronised the side stream, so the allocator cannot
    # hand its memory out while a copy still reads it.
    src = t.clone(memory_format=torch.contiguous_format) if snapshot \
        else t.contiguous()
    src = src.reshape(-1).view(torch.uint8)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    stream = _STAGER.side_stream(t.device)
    return Download(out, _STAGER.submit(
        lambda: _STAGER.run(src, ready, pieces, out, stream)))


def to_host_async(t: torch.Tensor, *, out: Optional[np.ndarray] = None
                  ) -> Download:
    """Start copying `t` to a NumPy array (`out`, a writable array of its
    shape and dtype, may be any view, such as a block of a larger grid);
    ``.result()`` waits and returns it. A CUDA tensor is first copied on
    its stream, so the caller may write into `t` or free it at once; the
    staging copies run on the side stream in pieces of at most
    ``CHUNK_BYTES``. A CPU tensor is copied before this returns."""
    return _start(t, out, snapshot=True)


def to_host(t: torch.Tensor, *, out: Optional[np.ndarray] = None
            ) -> np.ndarray:
    """`t` as a NumPy array (into `out` if given), through the pinned ring
    for a CUDA tensor: :func:`to_host_async` without the snapshot, since
    the caller waits."""
    return _start(t, out, snapshot=False).result()
