"""``tools.profile_stages`` on the CPU twins: the stages read from the
spans of ``generate_sdf`` on the binned path (icosphere(3) at 40^3; a torus
on a thin grid, whose pyramid runs permuted over odd level extents) and on
the dense path (box36), and the tool's entry points run."""

import json

import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
from sdfgenfast_tpu_torch.ops import vdt, vdt_kernel
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


def _count_k3_twin(monkeypatch):
    """On the CPU K3's twin launches nothing: count a launch a stride, as
    ``round_phase`` does on the card."""
    twin = vdt_kernel.round_phase_reference

    def counted(state, dx, strides, *args):
        vdt_kernel.round_phase.launches += len(strides)
        return twin(state, dx, strides, *args)

    monkeypatch.setattr(vdt_kernel, "round_phase_reference", counted)
    monkeypatch.setattr(vdt_kernel.round_phase, "launches", 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_from_spans(case, monkeypatch):
    """profile() splits generate_sdf by its spans: the route's stages are
    there, K3's launches follow the pyramid's schedule, the device stages
    read "not measured" on the CPU, and the launches of the stages that
    split a call sum to the root's."""
    make, nx = CASES[case]
    monkeypatch.setitem(ps.MESHES, case, make)
    _count_k3_twin(monkeypatch)
    run = ps.profile(case, nx, CPU, repeats=1)
    stages, launches = run["stages_ms"], run["launches"]
    assert set(launches) == set(stages) - {"end-to-end (warm)"}
    assert all(stages[k] == "not measured" for k in launches
               if k in ps.DEVICE)
    assert all(stages[k] >= 0 for k in launches if k in ps.HOST)
    total = sum(launches[k] for k in ps.SPLIT if k in launches)
    assert total == launches["sdf.generate_sdf"] \
        == launches["sdf.make_level_set3"]
    if case == "box36_24":
        assert run["binning"] is None and run["k3_rounds"] == 0
        assert {"sdf.dense.table", "sdf.dense.k1", "sdf.sign"} <= set(stages)
        assert "sdf.k3" not in stages and "sdf.band" not in stages
        return
    assert {"sdf.band", "sdf.far_field", "sdf.k3", "glue", "sdf.chamfer",
            "sdf.sign", "sdf.bin_mesh", "sdf.bin.parity", "sdf.bin.band",
            "sdf.bin.csr", "sdf.bin.upload", "sdf.to_host",
            "sdf.to_host.touch"} <= set(stages)
    grid = sizing_mode2a_proportional(*make().bounds(), nx, 1)
    shape = tuple(grid.shape[p] for p in _vdt_axis_perm(grid.shape))
    assert launches["sdf.k3"] == run["k3_rounds"] == _rounds(shape) == total
    assert launches["glue"] == 0
    levels = len(vdt.pyramid_level_shapes(shape))
    assert run["spans"]["sdf.k3"] == levels
    assert run["binning"]["A"] > 0 and run["binning"]["P"] > 0
    if case == "thin_torus_100":
        assert shape == (100, 30, 100) and levels == 3
        assert vdt.pyramid_level_shapes(shape)[1:] == [(50, 15, 50),
                                                       (25, 8, 25)]


def test_profile_entry_point_cpu(capsys):
    """main() on box36 at Nx 24: one JSON line, the stages of the call's
    spans each with its launches, and no device number from the CPU."""
    line = ps.main(["24", "box", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    (run,) = line["runs"]
    assert run["grid"] == [24, 31, 39] and "bit_equal" not in run
    assert run["profile"] == {"busy_share": "not measured",
                              "kernels": "not measured"}
    for k in ("sdf.bin.upload", "sdf.dense.k1", "sdf.sign", "sdf.to_host",
              "end-to-end (warm)"):
        assert k in run["stages_ms"]
    assert run["stages_ms"]["sdf.dense.k1"] == "not measured"
    assert run["launches"]["sdf.dense.k1"] == 0
    assert run["spans"]["sdf.sign"] == 1
    assert set(run["launches"]) == set(run["spans"]) \
        == set(run["stages_ms"]) - {"end-to-end (warm)"}
    with pytest.raises(ValueError, match="mesh"):
        ps.main(["24", "bunny", "--device", "cpu"])


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
