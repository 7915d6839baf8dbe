"""Wrappers for the jump-flood round (K3) and chamfer (K4) CUDA kernels.

Counterpart of ``sdfgenfast_tpu/ops/vdt_pallas.py``. Each wrapper launches
its kernel for a CUDA tensor and takes its plain-torch twin for a CPU
tensor; there is no shape gate and no fallback on CUDA (the Pallas wrappers
fell back to jnp for small or odd shapes and strides above 8 — the CUDA
kernels take every shape and stride).

``round_phase.launches`` and ``chamfer.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..kernels import build
from .vdt import _jacobi_round, _level_pos_axes, chamfer_relax, chamfer_steps

__all__ = ["round_phase", "round_phase_reference", "chamfer",
           "chamfer_reference", "chamfer_chunks"]


def _check_state(state):
    if state.dtype != torch.float32 or state.dim() != 4 or state.shape[0] != 5:
        raise ValueError(f"VDT state must be (5, ni, nj, nk) float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous():
        raise ValueError("VDT state must be contiguous")


def _ping_pong(x, n: int, launch):
    """Call ``launch(i, src, dst)`` for i = 0 .. n-1, alternating between two
    fresh buffers, so that no launch writes what it reads and `x` is never
    written. Returns the last output (a copy of `x` when n == 0)."""
    bufs = []
    for i in range(n):
        if len(bufs) < 2:
            bufs.append(torch.empty_like(x))
        dst = bufs[i % 2]
        launch(i, x, dst)
        x = dst
    return x if bufs else x.clone()


def _offset(pos_offset):
    off = (0, 0, 0) if pos_offset is None else tuple(int(v) for v in pos_offset)
    if len(off) != 3:
        raise ValueError(f"pos_offset must hold three ints, got {pos_offset}")
    return off


def round_phase_reference(state, dx: float, strides, scale: int = 1,
                          pos_offset=None):
    """Plain-torch twin of :func:`round_phase`: Jacobi rounds at a pyramid
    level whose cell I sits at fine position f32((I + pos_offset) * scale)
    * dx."""
    pos = _level_pos_axes(state.shape[1:], dx, scale, state.device,
                          _offset(pos_offset))
    for s in strides:
        state = _jacobi_round(state, *pos, s)
    return state


def round_phase(state, dx: float, strides, scale: int = 1, pos_offset=None):
    """Run Jacobi rounds (one per stride, in order) over a (5, ni, nj, nk)
    float32 state. `pos_offset` ((i, j, k) ints, negative allowed; None =
    zeros) is the global level index of local cell (0, 0, 0): a shard's
    halo-extended block scores its donors at global positions. CUDA: one
    K3 launch per stride into ping-pong buffers (the input is not
    modified). CPU: :func:`round_phase_reference`. One ``sdf.k3`` span a
    call."""
    _check_state(state)
    off = _offset(pos_offset)
    with tracing.span("sdf.k3", state.device):
        return _rounds(state, dx, strides, scale, off)


def _rounds(state, dx: float, strides, scale: int, off):
    """:func:`round_phase` after the checks."""
    if state.device.type == "cpu":
        return round_phase_reference(state, dx, strides, scale, off)
    if state.device.type != "cuda":
        raise ValueError(f"round_phase: unsupported device {state.device}")
    strides = [int(s) for s in strides]
    if any(s < 1 for s in strides):
        raise ValueError(f"round_phase: strides must be >= 1, got {strides}")
    _, ni, nj, nk = state.shape
    lib = build.library()
    stream = torch.cuda.current_stream(state.device).cuda_stream

    def launch(i, src, dst):
        with torch.cuda.device(state.device):
            build.check(lib.sdf_vdt_round(src.data_ptr(), dst.data_ptr(), ni,
                                          nj, nk, strides[i], int(scale),
                                          *off, float(dx), stream),
                        "sdf_vdt_round")
        round_phase.launches += 1

    return _ping_pong(state, len(strides), launch)


round_phase.launches = 0


def chamfer_reference(phi, dx: float, passes: int = 2):
    """Plain-torch twin of :func:`chamfer` (``vdt.chamfer_relax``)."""
    return chamfer_relax(phi, dx, passes)


# K4 (csrc/chamfer.cu) fuses up to CHAMFER_MAX_PASSES passes in a launch
# (the Pallas kernel's cap, vdt_pallas.py:352).
CHAMFER_MAX_PASSES = 4


def chamfer_chunks(passes: int):
    """The fused pass counts of K4's launches for `passes` passes: as many
    CHAMFER_MAX_PASSES as fit, then the rest; none for passes <= 0."""
    passes = max(int(passes), 0)
    full, rest = divmod(passes, CHAMFER_MAX_PASSES)
    return [CHAMFER_MAX_PASSES] * full + ([rest] if rest else [])


def chamfer(phi, dx: float, passes: int = 2):
    """`passes` 26-offset min-plus relaxation passes over a (ni, nj, nk)
    float32 field, into a new tensor. CUDA: one K4 launch per
    :func:`chamfer_chunks` entry (one launch for passes <= 4), fused passes
    marching i-planes through shared memory. CPU: :func:`chamfer_reference`."""
    if phi.dtype != torch.float32 or phi.dim() != 3 or not phi.is_contiguous():
        raise ValueError(f"chamfer: phi must be contiguous (ni, nj, nk) "
                         f"float32, got {tuple(phi.shape)} {phi.dtype}")
    if phi.device.type == "cpu":
        return chamfer_reference(phi, dx, passes)
    if phi.device.type != "cuda":
        raise ValueError(f"chamfer: unsupported device {phi.device}")
    if phi.numel() == 0:
        return phi.clone()
    s1, s2, s3 = chamfer_steps(dx)
    lib = build.library()
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    chunks = chamfer_chunks(passes)

    def launch(i, src, dst):
        with torch.cuda.device(phi.device):
            build.check(lib.sdf_chamfer(src.data_ptr(), dst.data_ptr(),
                                        *phi.shape, chunks[i], s1, s2, s3,
                                        stream), "sdf_chamfer")
        chamfer.launches += 1

    return _ping_pong(phi, len(chunks), launch)


chamfer.launches = 0
