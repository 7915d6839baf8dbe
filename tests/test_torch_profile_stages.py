"""``tools.profile_stages`` on the CPU twins: the staged composition of the
pipeline's functions equals ``make_level_set3`` bit for bit, in phi and
ids, on the binned path (icosphere(3) at 40^3; a torus on a thin grid,
whose pyramid runs permuted over odd level extents) and on the dense path
(box36), and the tool's entry points run."""

import json

import numpy as np
import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
from sdfgenfast_tpu_torch.ops import vdt
from sdfgenfast_tpu_torch.pipeline import _vdt_axis_perm
from sdfgenfast_tpu_torch.testing import box36
from sdfgenfast_tpu_torch.tools import profile_stages as ps

CPU = torch.device("cpu")

torch.set_num_threads(1)

CASES = {
    "icosphere3_40": (lambda: P.icosphere(3, radius=1.0,
                                          center=(0.05, -0.02, 0.03)), 40),
    # (100, 100, 30), permuted to (100, 30, 100): levels (50, 15, 50) and
    # (25, 8, 25)
    "thin_torus_100": (lambda: P.torus_mesh(24, 24), 100),
    "box36_24": (box36, 24),
}


def _rounds(shape):
    """K3 rounds of the pyramid schedule on `shape` (ops/vdt.py)."""
    shapes = vdt.pyramid_level_shapes(shape)
    coarse = len(vdt.stride_ladder(max(shapes[-1]), extra_rounds=1))
    if len(shapes) == 1:  # the ladder alone, at full resolution
        return coarse
    return (coarse + len(vdt.PYRAMID_COARSE_ROUNDS) * (len(shapes) - 2)
            + len(vdt.PYRAMID_LEVEL_ROUNDS) + 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_equals_make_level_set3(case):
    make, nx = CASES[case]
    mesh = make()
    grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
    phi, tid, info = ps.staged(mesh, grid, P.SDFConfig(), CPU, repeats=1)
    want, want_tid = P.make_level_set3(mesh, grid, device=CPU,
                                       return_tid=True)
    assert torch.equal(phi.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tid, want_tid)
    stages = info["stages"]
    assert all(ms >= 0 for ms in stages.values())
    if case == "box36_24":
        assert info["binning"] is None and info["k3_rounds"] == 0
        assert "K1" in stages and "pyramid K3 rounds" not in stages
        return
    shape = tuple(grid.shape[p] for p in _vdt_axis_perm(grid.shape))
    assert info["k3_rounds"] == _rounds(shape)
    assert info["binning"]["A"] > 0 and info["binning"]["P"] > 0
    levels = len(vdt.pyramid_level_shapes(shape))
    assert info["counts"]["pyramid K3 rounds"] == levels
    assert info["counts"].get("pyramid downsample", 0) == levels - 1
    # the frozen band is exact: its phi never changes after the band
    exact = info["exact"]
    assert exact.any() and torch.equal((want.abs() <= 3 * grid.dx) & exact,
                                       want.abs() <= 3 * grid.dx)
    if case == "thin_torus_100":
        assert shape == (100, 30, 100) and levels == 3
        assert vdt.pyramid_level_shapes(shape)[1:] == [(50, 15, 50),
                                                       (25, 8, 25)]


def test_profile_entry_point_cpu(capsys):
    """main() on box36 at Nx 24: one JSON line, the staged run bit-equal to
    the production call, and no device number from the CPU."""
    line = ps.main(["24", "box", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    (run,) = line["runs"]
    assert run["bit_equal"] and run["grid"] == [24, 31, 39]
    assert run["profile"] == {"busy_share": "not measured",
                              "kernels": "not measured"}
    for k in ("upload", "K1", "sign apply", "copy back (to_host)",
              "end-to-end (warm)"):
        assert k in run["stages_ms"]
    with pytest.raises(ValueError, match="mesh"):
        ps.main(["24", "bunny", "--device", "cpu"])
    with pytest.raises(ValueError, match="default route"):
        ps.staged(box36(), sizing_mode2a_proportional(*box36().bounds(), 8, 1),
                  P.SDFConfig(vdt_max_hop=8), CPU)


def test_device_profile_cpu_not_measured():
    assert ps.device_profile(lambda: None, CPU) == {
        "busy_share": "not measured", "kernels": "not measured"}


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::vdt_round_kernel<2>(unsigned int const*, "
     "unsigned int*, int, int)", "vdt_round_kernel<2>"),
    ("(anonymous namespace)::band_rows_kernel(float4 const*, int)",
     "band_rows_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 3ul> >(int, at::native::"
     "BinaryFunctor<float, float, float>)",
     "vectorized_elementwise_kernel<MulFunctor>"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> >(at::"
     "TensorIteratorBase&)::{lambda(int)#1}>(int)",
     "elementwise_kernel<CUDAFunctor_add>"),
])
def test_kernel_names_shortened(name, short):
    """The profile's kernel names: arguments dropped, long template lists
    cut to the functor they name."""
    assert ps._short(name) == short
