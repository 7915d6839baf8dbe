"""Probes of the card's ceilings: kernels P1-P4 (``csrc/probes.cu``).

Counterpart of ``tools/micro_bench.py``, whose Pallas probes grounded the
TPU kernels' designs. Here they measure the ceilings of the port's CUDA
kernels under the same build flags (``--fmad=false``, IEEE division and
sqrt) and the same ctypes launch path:

  P1 ``vpu_peak``       chain ``a = a*b + 1; b = b*a + 0.5``, 512 steps,
                        out ``a + b``; (16384, 512) float32. Without FMA
                        (separate multiply and add, as the distance kernels
                        are built) and with explicit FMA (the FP32 peak).
  P2 ``vpu_mixed``      multiply, add, compare and select chain, 256 steps,
                        out ``best``; (16384, 512) float32.
  P3 ``grid_overhead``  ``o = x*2`` with one CTA per TPU grid step: 10000
                        blocks of (128, 48) and 1250 of (1024, 48), each
                        tile moved by bulk copies through a ring of
                        shared-memory stages (:func:`grid_plan`).
  P4 ``hbm_stream``     ``o = x + 1`` over (131072, 512) float32, 268 MB in
                        and 268 MB out, by the same kernel: one CTA per
                        tile of HBM_TILE floats, one stage each.

Each wrapper launches its kernel for a CUDA tensor (counting launches in
``<wrapper>.launches``) and runs its plain-torch twin, the same chain as
torch operations, for a CPU tensor. The FMA variant's twin does each
multiply-add in float64 and rounds once to float32.

The launchers' arguments come from plain functions that the CPU tests
check: :func:`grid_plan` (P3's ring) and :func:`tile_pieces` (how a CTA
cuts its tile, in P3 and P4).

Timing (:func:`time_ms`): `reps` launches back to back, queued behind a
spin of the card so that the host's launch work stays out of the CUDA
events, median of `repeats` such runs after a warm-up. Run on a machine
with a card::

    python3 -m sdfgenfast_tpu_torch.tools.micro_bench

It prints the JAX tool's lines (Tflop/s, Tops/s, ns per block, GB/s) and
one JSON line, and raises, naming CUDA, when there is no card.
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics

import numpy as np
import torch

from ..kernels import build
from ..platform import require_cuda

__all__ = ["vpu_peak", "vpu_peak_reference", "vpu_mixed",
           "vpu_mixed_reference", "grid_overhead", "grid_overhead_reference",
           "hbm_stream", "hbm_stream_reference", "grid_plan", "tile_pieces",
           "time_ms", "run"]

# the Pallas probes' sizes (tools/micro_bench.py)
VPU_SHAPE = (256 * 64, 512)
PEAK_CHAIN = 512
MIXED_CHAIN = 256
GRID_COLS = 48
GRID_CASES = ((10000, 128), (1250, 1024))  # (blocks, rows per block)
HBM_SHAPE = (512 * 256, 512)

# csrc/probes.cu: up to MAX_STAGES stages after BAR_BYTES of barriers; a
# stage's bytes are one barrier's transaction count, below 2^20
MAX_STAGES = 16
BAR_BYTES = 128
MAX_STAGE_BYTES = (1 << 20) - 16
# P3: a tile of up to GRID_ONE_CHUNK floats (32 KB) is one stage, a larger
# one goes through a ring of GRID_RING = (stages, chunk floats), its next
# loads in flight while a chunk is scaled and stored. The card streams
# fastest with few tiles in flight, so a launch asks for enough shared
# memory to hold an SM to GRID_CTAS_PER_SM CTAs: 2 for the tool's (128, 48)
# tiles, while the (1024, 48) tiles' ring (131 KB) holds it to 1 by
# itself. Both were the fastest measured (PERF.md section 6).
GRID_ONE_CHUNK = 8192
GRID_RING = (4, 8192)
GRID_CTAS_PER_SM = 2
# P4: one CTA per tile of HBM_TILE floats (16 KB, one stage), at most
# HBM_CTAS_PER_SM CTAs an SM: 48 KB in flight an SM, as P3's small tiles
# have. The fastest of tiles of 16-128 KB at 1-13 CTAs an SM (PERF.md
# section 6).
HBM_TILE = 4096
HBM_CTAS_PER_SM = 3

# float32 constants of the chains, as Python floats
_F = {v: float(np.float32(v)) for v in (1.000001, 0.5, 0.25, 3e18, 0.125,
                                         0.999)}


def _check(x, name: str):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")


def _launch(entry: str, x, out, *args):
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(getattr(lib, entry)(x.data_ptr(), out.data_ptr(), *args,
                                        stream), entry)
    return out


@functools.lru_cache(maxsize=None)
def _tile_plan(device_index: int, add: bool, ring: int, ctas_per_sm: int):
    """(dynamic shared memory, resident CTAs per SM, threads per CTA, SMs)
    of a launch of P3's (`add` False) or P4's kernel whose ring takes
    `ring` bytes, held to at most `ctas_per_sm` CTAs an SM
    (``sdf_probe_tile_plan``)."""
    lib = build.library()
    smem = ctypes.c_longlong(0)
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(lib.sdf_probe_tile_plan(
            int(add), ring, ctas_per_sm, ctypes.byref(smem),
            ctypes.byref(blocks), ctypes.byref(threads)),
            "sdf_probe_tile_plan")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if blocks.value < 1:
        raise RuntimeError(f"the tile kernel does not fit an SM with "
                           f"{smem.value} B of shared memory")
    return smem.value, blocks.value, threads.value, sms


def _launch_tiles(entry: str, x, out, tile: int, stages: int, chunk: int,
                  ctas_per_sm: int) -> dict:
    """One launch of ``tile_kernel`` (`entry`: P3's or P4's) over x's
    floats in tiles of `tile`, through a ring of `stages` x `chunk` floats;
    returns the launch's configuration."""
    smem, per_sm, threads, sms = _tile_plan(
        x.device.index, entry == "sdf_probe_add1",
        BAR_BYTES + 4 * stages * chunk, ctas_per_sm)
    _launch(entry, x, out, x.numel(), tile, stages, chunk, smem)
    return dict(grid=-(-x.numel() // tile), threads=threads, stages=stages,
                chunk=chunk, smem=smem, per_sm=per_sm, resident=per_sm * sms)


def _fma(u, v, w):
    """float32 u*v + w rounded once: the product of two float32 values is
    exact in float64, so only the sum rounds (and then the cast)."""
    return (u.double() * v + w).to(torch.float32)


# -- P1 ---------------------------------------------------------------------


def vpu_peak_reference(x, chain: int = PEAK_CHAIN, fma: bool = False):
    """Plain-torch twin of :func:`vpu_peak`."""
    a = x
    if fma:
        b = _fma(a, _F[1.000001], 0.5)
        for _ in range(chain):
            a = _fma(a, b.double(), 1.0)
            b = _fma(b, a.double(), 0.5)
    else:
        b = a * _F[1.000001] + 0.5
        for _ in range(chain):
            a = a * b + 1.0
            b = b * a + 0.5
    return a + b


def vpu_peak(x, chain: int = PEAK_CHAIN, fma: bool = False):
    """P1: the multiply-add chain, one thread per element. CUDA: one launch
    of ``vpu_peak_kernel``. CPU: :func:`vpu_peak_reference`."""
    _check(x, "vpu_peak")
    if x.device.type == "cpu":
        return vpu_peak_reference(x, chain, fma)
    out = _launch("sdf_probe_vpu_peak", x, torch.empty_like(x), x.numel(),
                  int(chain), int(fma))
    vpu_peak.launches += 1
    return out


vpu_peak.launches = 0


# -- P2 ---------------------------------------------------------------------


def vpu_mixed_reference(x, chain: int = MIXED_CHAIN):
    """Plain-torch twin of :func:`vpu_mixed`."""
    a = x
    b = a + _F[0.25]
    best = a * 0.0 + _F[3e18]
    for _ in range(chain):
        d = a * b + 1.0
        d = d * d
        best = torch.where(d < best, d, best)
        a = a + _F[0.125]
        b = b * _F[0.999]
    return best


def vpu_mixed(x, chain: int = MIXED_CHAIN):
    """P2: multiply, add, compare and select. CUDA: one launch of
    ``vpu_mixed_kernel``. CPU: :func:`vpu_mixed_reference`."""
    _check(x, "vpu_mixed")
    if x.device.type == "cpu":
        return vpu_mixed_reference(x, chain)
    out = _launch("sdf_probe_vpu_mixed", x, torch.empty_like(x), x.numel(),
                  int(chain))
    vpu_mixed.launches += 1
    return out


vpu_mixed.launches = 0


# -- P3 ---------------------------------------------------------------------


def grid_plan(block_floats: int):
    """(stages, chunk floats) of P3's ring for tiles of `block_floats`
    floats: one stage that holds the whole body up to GRID_ONE_CHUNK
    floats, else GRID_RING."""
    if block_floats <= GRID_ONE_CHUNK:
        return 1, max(4, block_floats // 4 * 4)
    return GRID_RING


def tile_pieces(b: int, n: int, tile: int, lead: int, chunk: int):
    """How ``tile_kernel``'s CTA `b` cuts its tile, floats [b * tile,
    min((b + 1) * tile, n)) of x, which starts `lead` floats past a 16-byte
    boundary: [(kind, start, length)] in floats of x, a scalar "head" up to
    the first 16-byte boundary, the body's "chunk"s of at most `chunk`
    floats, a scalar "tail" of up to 3."""
    base = b * tile
    size = min(tile, n - base)
    head = min((4 - (lead + base) % 4) % 4, size)
    body = (size - head) // 4 * 4
    pieces = [("head", base, head)] if head else []
    pieces += [("chunk", base + head + c, min(chunk, body - c))
               for c in range(0, body, chunk)]
    tail = size - head - body
    if tail:
        pieces.append(("tail", base + head + body, tail))
    return pieces


def grid_overhead_reference(x, n_blocks: int):
    """Plain-torch twin of :func:`grid_overhead`."""
    return x * 2.0


def _lead_matched_like(x):
    """An empty tensor like `x` whose data starts at the same offset from a
    16-byte boundary, so that P3's bulk copies take the same floats of both."""
    lead = x.data_ptr() // 4 % 4
    buf = torch.empty(x.numel() + lead, dtype=x.dtype, device=x.device)
    return buf[lead:].view(x.shape)


def grid_overhead(x, n_blocks: int):
    """P3: ``x * 2`` with one CTA for each of `n_blocks` equal row blocks of
    `x` (one TPU grid step each), its tile moved by bulk copies through the
    ring of :func:`grid_plan`, at most GRID_CTAS_PER_SM CTAs an SM. CUDA:
    one launch of ``tile_kernel<false>``; the launch's configuration is
    kept in ``grid_overhead.last_launch``. CPU:
    :func:`grid_overhead_reference`."""
    _check(x, "grid_overhead")
    if n_blocks <= 0 or x.numel() % n_blocks:
        raise ValueError(f"grid_overhead: {x.numel()} floats do not split "
                         f"into {n_blocks} blocks")
    if x.device.type == "cpu":
        return grid_overhead_reference(x, n_blocks)
    block_floats = x.numel() // n_blocks
    if block_floats == 0:
        return torch.empty_like(x)
    out = _lead_matched_like(x)
    grid_overhead.last_launch = _launch_tiles(
        "sdf_probe_scale2", x, out, block_floats, *grid_plan(block_floats),
        GRID_CTAS_PER_SM)
    grid_overhead.launches += 1
    return out


grid_overhead.launches = 0
grid_overhead.last_launch = None


# -- P4 ---------------------------------------------------------------------


def hbm_stream_reference(x):
    """Plain-torch twin of :func:`hbm_stream`."""
    return x + 1.0


def hbm_stream(x):
    """P4: ``x + 1`` over a 16-byte-aligned `x`, one CTA per tile of
    HBM_TILE floats (the last one ragged), each moved by bulk copies in one
    stage, at most HBM_CTAS_PER_SM CTAs an SM. CUDA: one launch of
    ``tile_kernel<true>``; its configuration is kept in
    ``hbm_stream.last_launch``. CPU: :func:`hbm_stream_reference`."""
    _check(x, "hbm_stream")
    if x.device.type == "cpu":
        return hbm_stream_reference(x)
    if x.data_ptr() % 16:
        raise ValueError("hbm_stream: x must be 16-byte aligned")
    if x.numel() == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    hbm_stream.last_launch = _launch_tiles(
        "sdf_probe_add1", x, out, HBM_TILE, 1, HBM_TILE, HBM_CTAS_PER_SM)
    hbm_stream.launches += 1
    return out


hbm_stream.launches = 0
hbm_stream.last_launch = None


# -- the tool -----------------------------------------------------------------


def time_ms(fn, reps: int = 10, repeats: int = 3) -> float:
    """Device time of one fn() in ms: `reps` calls back to back, queued
    behind a ~1 ms spin of the card so that the host's launch work (the
    output's allocation, the ctypes call) overlaps the device and stays out
    of the CUDA events; the median of `repeats` such runs, after a
    synchronize and one warm-up call. fn() runs 1 + reps * repeats times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def run(device, reps: int = 10, repeats: int = 3) -> dict:
    """Run every probe on `device` (a CUDA device) at the Pallas probes'
    sizes; print the JAX tool's lines and return the numbers. Each probe
    case is one :func:`time_ms`: 1 + reps * repeats launches
    (``launches_per_case``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes measure a CUDA card, got {device}")
    if reps < 10 or repeats < 3:
        raise ValueError("reps must be >= 10 and repeats >= 3")
    res = {"device": torch.cuda.get_device_name(device),
           "launches_per_case": 1 + reps * repeats}

    x = torch.ones(HBM_SHAPE, dtype=torch.float32, device=device)
    t = time_ms(lambda: hbm_stream(x), reps, repeats)
    nbytes = x.numel() * 4 * 2
    res["hbm_stream"] = {"ms": t, "gb_s": nbytes / t / 1e6,
                         "launch": hbm_stream.last_launch}
    print(f"HBM stream: {nbytes / t / 1e6:.0f} GB/s ({t:.4f} ms for "
          f"{nbytes / 1e6:.0f} MB); {hbm_stream.last_launch}", flush=True)
    del x

    x = torch.ones(VPU_SHAPE, dtype=torch.float32, device=device)
    flops = x.numel() * PEAK_CHAIN * 4  # 2 multiply-adds per step
    for fma, key, label in ((False, "vpu_peak", "mul+add"),
                            (True, "vpu_peak_fma", "fma")):
        t = time_ms(lambda: vpu_peak(x, PEAK_CHAIN, fma), reps, repeats)
        res[key] = {"ms": t, "tflop_s": flops / t / 1e9}
        print(f"VPU {label} chain: {flops / t / 1e9:.2f} Tflop/s "
              f"({t:.4f} ms)", flush=True)
    ops = x.numel() * MIXED_CHAIN * 7
    t = time_ms(lambda: vpu_mixed(x, MIXED_CHAIN), reps, repeats)
    res["vpu_mixed"] = {"ms": t, "tops_s": ops / t / 1e9}
    print(f"VPU mixed (fma/mul/cmp/sel): {ops / t / 1e9:.2f} Tops/s "
          f"({t:.4f} ms)", flush=True)
    del x

    res["grid_overhead"] = []
    for n_blocks, rows in GRID_CASES:
        x = torch.ones((n_blocks * rows, GRID_COLS), dtype=torch.float32,
                       device=device)
        t = time_ms(lambda: grid_overhead(x, n_blocks), reps, repeats)
        gbs = x.numel() * 4 * 2 / t / 1e6
        res["grid_overhead"].append({"blocks": n_blocks, "rows": rows,
                                     "ms": t, "ns_per_block": t / n_blocks
                                     * 1e6, "gb_s": gbs,
                                     "launch": grid_overhead.last_launch})
        print(f"grid blocks={n_blocks} block=({rows},{GRID_COLS}): "
              f"{t:.4f} ms -> {t / n_blocks * 1e6:.1f} ns/block, "
              f"{gbs:.0f} GB/s; {grid_overhead.last_launch}", flush=True)
    return res


def main():
    require_cuda()
    print(json.dumps(run(torch.device("cuda", torch.cuda.current_device()))),
          flush=True)


if __name__ == "__main__":
    main()
