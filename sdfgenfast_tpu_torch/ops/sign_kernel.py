"""The sign stage in one kernel: the x-ray parity decoded, or phi signed by
it, in one pass over the grid.

The parity reaches the device in one of three forms: the host's bit-packed
field ((ceil(ni/8), nj, nk) uint8), its int16 crossing positions ((C, nj,
nk)), or the device sign's (ni, nj, nk) bool field. :func:`parity_sign`
either decodes it to the bool field that R1 and R1b read (a bool field is
returned as it is), or flips phi's sign where it is odd, in place where
the caller owns phi.

CUDA tensors: one launch of ``parity_sign_kernel`` (``csrc/sign.cu``),
byte-equal to the twins; ``parity_sign.launches`` counts them. CPU
tensors: the plain-torch twins, ``sign_host.unpack_parity_device``,
``sign_host.parity_from_crossings_device`` and ``torch.where(parity,
-phi, phi)``.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .sign_host import parity_from_crossings_device, unpack_parity_device

__all__ = ["parity_sign", "parity_sign_reference"]

# the kernel's `kind` of each parity form
_KINDS = {torch.uint8: 0, torch.int16: 1, torch.bool: 2}


def _decode_reference(parity, ni: int):
    if parity.dtype == torch.bool:
        return parity
    if parity.dtype == torch.int16:
        return parity_from_crossings_device(parity, ni)
    return unpack_parity_device(parity, ni)


def parity_sign_reference(parity, ni: int, phi=None):
    """Plain-torch twin of :func:`parity_sign` (never in place)."""
    p = _decode_reference(parity, ni)
    return p if phi is None else torch.where(p, -phi, phi)


def _check(parity, ni: int, phi):
    if parity.dtype not in _KINDS or parity.dim() != 3:
        raise ValueError(f"parity must be 3-D uint8 (packed), int16 "
                         f"(crossings) or bool, got {tuple(parity.shape)} "
                         f"{parity.dtype}")
    rows = int(parity.shape[0])
    if ni < 0 or {torch.uint8: rows < -(-ni // 8),
                  torch.bool: rows != ni}.get(parity.dtype, False):
        raise ValueError(f"parity with {rows} rows does not cover ni = {ni}")
    if phi is not None and (
            phi.dtype != torch.float32
            or tuple(phi.shape) != (ni, *parity.shape[1:])
            or phi.device != parity.device):
        raise ValueError(f"phi must be float32 {(ni, *parity.shape[1:])} on "
                         f"{parity.device}, got {tuple(phi.shape)} "
                         f"{phi.dtype} on {phi.device}")


@build.counted
def parity_sign(parity, ni: int, phi=None, *, inplace: bool = False):
    """Decode (`phi` None): the (ni, nj, nk) bool parity of `parity`
    (packed uint8, int16 crossings, or a bool field, returned as it is).
    Sign: `phi` (ni, nj, nk) float32 negated where the parity is odd, bit
    for bit ``torch.where(parity, -phi, phi)``; with `inplace` written
    into `phi` (contiguous) and returned, else a fresh tensor.

    CUDA: one launch of ``parity_sign_kernel`` (none to decode a bool
    field or an empty grid). CPU: :func:`parity_sign_reference`."""
    _check(parity, ni, phi)
    if phi is None and parity.dtype == torch.bool:
        return parity
    if inplace and (phi is None or not phi.is_contiguous()):
        raise ValueError("inplace needs a contiguous phi")
    if parity.device.type == "cpu":
        out = parity_sign_reference(parity, ni, phi)
        return phi.copy_(out) if inplace else out
    if parity.device.type != "cuda":
        raise ValueError(f"parity_sign: unsupported device {parity.device}")
    parity = parity.contiguous()
    nj, nk = int(parity.shape[1]), int(parity.shape[2])
    if phi is None:
        out = torch.empty((ni, nj, nk), dtype=torch.bool,
                          device=parity.device)
    else:
        phi = phi.contiguous()
        out = phi if inplace else torch.empty_like(phi)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(parity.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.sdf_parity_sign(
            parity.data_ptr(), _KINDS[parity.dtype], int(parity.shape[0]),
            None if phi is None else phi.data_ptr(), out.data_ptr(), ni, nj,
            nk, stream), "sdf_parity_sign")
    parity_sign.launches += 1
    return out
