"""The probe tool's twins (kernels P1-P4 of ``sdfgenfast_tpu_torch.tools.
micro_bench``) against the TPU probes' own bodies.

The bodies of ``tools/micro_bench.py`` (``:62-73``, ``:93-109``, ``:129-130``
and ``:150-151``) are closures at fixed sizes, so they are restated here
exactly, with the chain length as a parameter, and run through
``pl.pallas_call(..., interpret=True)`` on a small grid. XLA's CPU compiler
fuses ``a * b + c`` into one FMA inside those bodies (even with jit
disabled), so:

- P3 (``x * 2``) and P4 (``x + 1``) are compared bit for bit;
- P1 at the tool's 512 steps overflows to non-finite values everywhere, as
  on the TPU: bit for bit (NaN compared as NaN) for both variants;
- P1's FMA variant matches the fused body to 1 ulp (measured: bit for bit)
  on short chains whose values stay finite;
- P1 without FMA and P2 round every product and sum on their own, so on
  finite values they are held to the body with a relative tolerance: 1e-6
  for one P1 step (two multiply-adds, each at most one rounding apart), and
  1e-6 for P2's 256 steps on positive inputs (``a*b + 1 >= 1`` cannot
  cancel, so each fused step is within an ulp and the running minimum keeps
  the largest relative error of one step);
- both are bit for bit equal to a NumPy float32 restatement that rounds
  every operation, which is what the CUDA kernels (built ``--fmad=false``)
  compute.

On the card ``chip_smoke.py`` holds each kernel against these twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdfgenfast_tpu_torch.tools import micro_bench as mb

torch.set_num_threads(1)

SUB, LANES, NB = 8, 128, 3


def _call(kernel, x, sub=SUB, lanes=LANES):
    nb = x.shape[0] // sub
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((sub, lanes), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((sub, lanes), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))


def _peak_kernel(CHAIN):
    def kernel(x_ref, o_ref):
        a = x_ref[:]
        b = a * 1.000001 + 0.5

        def body(i, carry):
            a, b = carry
            a = a * b + 1.0
            b = b * a + 0.5
            return a, b

        a, b = jax.lax.fori_loop(0, CHAIN, body, (a, b))
        o_ref[:] = a + b
    return kernel


def _mixed_kernel(CHAIN):
    def kernel(x_ref, o_ref):
        a = x_ref[:]
        b = a + 0.25
        best = a * 0.0 + 3e18

        def body(i, carry):
            a, b, best = carry
            d = a * b + 1.0         # fma
            d = d * d               # mul
            m = d < best            # cmp
            best = jnp.where(m, d, best)  # select
            a = a + 0.125
            b = b * 0.999
            return a, b, best

        a, b, best = jax.lax.fori_loop(0, CHAIN, body, (a, b, best))
        o_ref[:] = best
    return kernel


def _scale2_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


def _add1_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] + 1.0


def _x(lo=-1.5, hi=1.5, seed=0, shape=(SUB * NB, LANES)):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _bits_equal(a, b):
    """Bit for bit, every NaN counted equal to every NaN."""
    same = a.view(np.int32) == b.view(np.int32)
    return bool((same | (np.isnan(a) & np.isnan(b))).all())


def _np_peak(x, chain):
    """P1 without FMA in NumPy float32, every operation rounded."""
    f = np.float32
    a = x.copy()
    b = a * f(1.000001) + f(0.5)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(chain):
            a = a * b + f(1.0)
            b = b * a + f(0.5)
        return a + b


def _np_mixed(x, chain):
    f = np.float32
    a = x.copy()
    b = a + f(0.25)
    best = a * f(0.0) + f(3e18)
    for _ in range(chain):
        d = a * b + f(1.0)
        d = d * d
        best = np.where(d < best, d, best)
        a = a + f(0.125)
        b = b * f(0.999)
    return best


@pytest.mark.parametrize("fma", [False, True])
def test_vpu_peak_at_the_tools_chain_matches_the_pallas_body(fma):
    x = _x()
    want = _call(_peak_kernel(mb.PEAK_CHAIN), x)
    got = mb.vpu_peak(torch.from_numpy(x), mb.PEAK_CHAIN, fma=fma).numpy()
    assert not np.isfinite(want).any()  # the chain overflows, as on the TPU
    assert _bits_equal(got, want)


@pytest.mark.parametrize("chain", [1, 3, 8])
def test_vpu_peak_fma_matches_the_fused_pallas_body(chain):
    x = _x(seed=chain)
    want = _call(_peak_kernel(chain), x)
    got = mb.vpu_peak(torch.from_numpy(x), chain, fma=True).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.1
    # ulp distance on finite values (both of one sign where they agree)
    ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                  - want[fin].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("chain", [1, 3, 8])
def test_vpu_peak_rounds_every_operation(chain):
    x = _x(seed=chain)
    got = mb.vpu_peak(torch.from_numpy(x), chain).numpy()
    assert _bits_equal(got, _np_peak(x, chain))
    if chain == 1:
        want = _call(_peak_kernel(chain), x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_vpu_mixed_matches_the_pallas_body():
    x = _x(0.5, 1.5)
    want = _call(_mixed_kernel(mb.MIXED_CHAIN), x)
    got = mb.vpu_mixed(torch.from_numpy(x), mb.MIXED_CHAIN).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert _bits_equal(got, _np_mixed(x, mb.MIXED_CHAIN))


def test_vpu_mixed_rounds_every_operation_on_mixed_signs():
    x = _x(seed=4)
    got = mb.vpu_mixed(torch.from_numpy(x), mb.MIXED_CHAIN).numpy()
    assert _bits_equal(got, _np_mixed(x, mb.MIXED_CHAIN))


@pytest.mark.parametrize("n_blocks,rows", [(40, 128), (5, 1024)])
def test_grid_overhead_matches_the_pallas_body(n_blocks, rows):
    x = _x(seed=rows, shape=(n_blocks * rows, mb.GRID_COLS))
    x[0, :4] = [np.inf, -np.inf, np.nan, 3e38]
    want = _call(_scale2_kernel, x, sub=rows, lanes=mb.GRID_COLS)
    got = mb.grid_overhead(torch.from_numpy(x), n_blocks).numpy()
    assert _bits_equal(got, want)


def test_hbm_stream_matches_the_pallas_body():
    x = _x(seed=7, shape=(512 * 2, 512))
    x[0, :3] = [np.inf, np.nan, -0.0]
    want = _call(_add1_kernel, x, sub=512, lanes=512)
    got = mb.hbm_stream(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, want)


def test_wrappers_validate_their_input():
    x = torch.ones((4, 48))
    with pytest.raises(ValueError, match="float32"):
        mb.hbm_stream(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        mb.vpu_peak(x.T)
    with pytest.raises(ValueError, match="blocks"):
        mb.grid_overhead(x, 5)


def test_the_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.main()
    with pytest.raises(ValueError, match="CUDA"):
        mb.run(torch.device("cpu"))
