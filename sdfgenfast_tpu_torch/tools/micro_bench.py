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
  P3 ``grid_overhead``  ``o = x*2`` with one thread block per TPU grid step:
                        10000 blocks of (128, 48) and 1250 of (1024, 48).
  P4 ``hbm_stream``     ``o = x + 1`` over (131072, 512) float32, 268 MB in
                        and 268 MB out.

Each wrapper launches its kernel for a CUDA tensor (counting launches in
``<wrapper>.launches``) and runs its plain-torch twin, the same chain as
torch operations, for a CPU tensor. The FMA variant's twin does each
multiply-add in float64 and rounds once to float32.

Timing: CUDA events around one launch after a synchronize, median of
``reps`` (>= 10) runs after a warm-up. Run on a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.micro_bench

It prints the JAX tool's lines (Tflop/s, Tops/s, ns per block, GB/s) and
one JSON line, and raises, naming CUDA, when there is no card.
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from ..kernels import build
from ..platform import require_cuda

__all__ = ["vpu_peak", "vpu_peak_reference", "vpu_mixed",
           "vpu_mixed_reference", "grid_overhead", "grid_overhead_reference",
           "hbm_stream", "hbm_stream_reference", "run"]

# the Pallas probes' sizes (tools/micro_bench.py)
VPU_SHAPE = (256 * 64, 512)
PEAK_CHAIN = 512
MIXED_CHAIN = 256
GRID_COLS = 48
GRID_CASES = ((10000, 128), (1250, 1024))  # (blocks, rows per block)
HBM_SHAPE = (512 * 256, 512)

# float32 constants of the chains, as Python floats
_F = {v: float(np.float32(v)) for v in (1.000001, 0.5, 0.25, 3e18, 0.125,
                                         0.999)}


def _check(x, name: str):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")


def _launch(entry: str, x, *args):
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    out = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(getattr(lib, entry)(x.data_ptr(), out.data_ptr(), *args,
                                        stream), entry)
    return out


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
    out = _launch("sdf_probe_vpu_peak", x, x.numel(), int(chain), int(fma))
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
    out = _launch("sdf_probe_vpu_mixed", x, x.numel(), int(chain))
    vpu_mixed.launches += 1
    return out


vpu_mixed.launches = 0


# -- P3 ---------------------------------------------------------------------


def grid_overhead_reference(x, n_blocks: int):
    """Plain-torch twin of :func:`grid_overhead`."""
    return x * 2.0


def grid_overhead(x, n_blocks: int):
    """P3: ``x * 2`` with one thread block for each of `n_blocks` equal
    row blocks of `x` (one TPU grid step each). CUDA: one launch of
    ``scale2_kernel``. CPU: :func:`grid_overhead_reference`."""
    _check(x, "grid_overhead")
    if n_blocks <= 0 or x.numel() % n_blocks:
        raise ValueError(f"grid_overhead: {x.numel()} floats do not split "
                         f"into {n_blocks} blocks")
    if x.device.type == "cpu":
        return grid_overhead_reference(x, n_blocks)
    out = _launch("sdf_probe_scale2", x, int(n_blocks),
                  x.numel() // n_blocks)
    grid_overhead.launches += 1
    return out


grid_overhead.launches = 0


# -- P4 ---------------------------------------------------------------------


def hbm_stream_reference(x):
    """Plain-torch twin of :func:`hbm_stream`."""
    return x + 1.0


def hbm_stream(x):
    """P4: ``x + 1`` streamed with 16-byte loads and stores. CUDA: one
    launch of ``add1_kernel``. CPU: :func:`hbm_stream_reference`."""
    _check(x, "hbm_stream")
    if x.device.type == "cpu":
        return hbm_stream_reference(x)
    if x.data_ptr() % 16:
        raise ValueError("hbm_stream: x must be 16-byte aligned")
    out = _launch("sdf_probe_add1", x, x.numel())
    hbm_stream.launches += 1
    return out


hbm_stream.launches = 0


# -- the tool -----------------------------------------------------------------


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() in ms: CUDA events around each of `reps`
    runs, after a synchronize and one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(device, reps: int = 10) -> dict:
    """Run every probe on `device` (a CUDA device) at the Pallas probes'
    sizes; print the JAX tool's lines and return the numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes measure a CUDA card, got {device}")
    if reps < 10:
        raise ValueError("reps must be >= 10")
    res = {"device": torch.cuda.get_device_name(device)}

    x = torch.ones(HBM_SHAPE, dtype=torch.float32, device=device)
    t = time_ms(lambda: hbm_stream(x), reps)
    nbytes = x.numel() * 4 * 2
    res["hbm_stream"] = {"ms": t, "gb_s": nbytes / t / 1e6}
    print(f"HBM stream: {nbytes / t / 1e6:.0f} GB/s ({t:.3f} ms for "
          f"{nbytes / 1e6:.0f} MB)", flush=True)
    del x

    x = torch.ones(VPU_SHAPE, dtype=torch.float32, device=device)
    flops = x.numel() * PEAK_CHAIN * 4  # 2 multiply-adds per step
    for fma, key, label in ((False, "vpu_peak", "mul+add"),
                            (True, "vpu_peak_fma", "fma")):
        t = time_ms(lambda: vpu_peak(x, PEAK_CHAIN, fma), reps)
        res[key] = {"ms": t, "tflop_s": flops / t / 1e9}
        print(f"VPU {label} chain: {flops / t / 1e9:.2f} Tflop/s "
              f"({t:.3f} ms)", flush=True)
    ops = x.numel() * MIXED_CHAIN * 7
    t = time_ms(lambda: vpu_mixed(x, MIXED_CHAIN), reps)
    res["vpu_mixed"] = {"ms": t, "tops_s": ops / t / 1e9}
    print(f"VPU mixed (fma/mul/cmp/sel): {ops / t / 1e9:.2f} Tops/s "
          f"({t:.3f} ms)", flush=True)
    del x

    res["grid_overhead"] = []
    for n_blocks, rows in GRID_CASES:
        x = torch.ones((n_blocks * rows, GRID_COLS), dtype=torch.float32,
                       device=device)
        t = time_ms(lambda: grid_overhead(x, n_blocks), reps)
        gbs = x.numel() * 4 * 2 / t / 1e6
        res["grid_overhead"].append({"blocks": n_blocks, "rows": rows,
                                     "ms": t, "ns_per_block": t / n_blocks
                                     * 1e6, "gb_s": gbs})
        print(f"grid blocks={n_blocks} block=({rows},{GRID_COLS}): "
              f"{t:.3f} ms -> {t / n_blocks * 1e6:.0f} ns/block, "
              f"{gbs:.0f} GB/s", flush=True)
    return res


def main():
    require_cuda()
    print(json.dumps(run(torch.device("cuda", torch.cuda.current_device()))),
          flush=True)


if __name__ == "__main__":
    main()
