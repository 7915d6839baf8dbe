"""The PyTorch port's CLI and .vti writer, on the CPU.

Ports of tests/test_cli.py, test_cli_formats.py and test_vti.py, run
in-process through ``cli.main(argv)`` with ``SDFGEN_TORCH_BACKEND=cpu``, plus
the three box goldens through the CLI (output names and stdout lines from
tests/goldens/manifest.json, values to the bars of
tests/test_parity_golden.py) and a few ``python -m`` subprocess cases for
the usage text, exit codes and the refusal to run without CUDA unless the
CPU is asked for."""

import base64
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from sdfgenfast_tpu import cli as jcli
from sdfgenfast_tpu.io.vti import write_vti as jwrite_vti
from sdfgenfast_tpu_torch import cli
from sdfgenfast_tpu_torch.io.vti import write_vti

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dense import (  # noqa: E402
    MANIFEST, BOX_GOLDENS, assert_golden_bars, golden_grid)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RESOURCES = os.path.join(HERE, "resources")

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    for name in ("box345.stl", "box345.obj", "box345_ascii.stl"):
        shutil.copy(os.path.join(RESOURCES, name), tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(cli.BACKEND_ENV, "cpu")
    monkeypatch.delenv(cli.VTI_ENV, raising=False)
    return tmp_path


def run(capsys, *args):
    """cli.main in-process: (exit code, stdout, stderr)."""
    rc = cli.main(["sdfgen-torch", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def run_subprocess(args, cwd, backend=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", cli.BACKEND_ENV)}
    env["PYTHONPATH"] = REPO
    if backend is not None:
        env[cli.BACKEND_ENV] = backend
    return subprocess.run(
        [sys.executable, "-m", "sdfgenfast_tpu_torch.cli", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def read_sdf(path):
    raw = open(path, "rb").read()
    dims = tuple(int(d) for d in np.frombuffer(raw[:12], "<i4"))
    bmin = np.frombuffer(raw[12:24], "<f4")
    return dims, bmin, np.frombuffer(raw[36:], "<f4")


def read_vti(path):
    root = ET.parse(path).getroot()  # raises on malformed XML
    assert root.tag == "VTKFile" and root.get("type") == "ImageData"
    image = root.find("ImageData")
    arr = image.find("Piece").find("PointData").find("DataArray")
    assert arr.get("type") == "Float32" and arr.get("format") == "binary"
    raw = base64.b64decode(arr.text.strip())
    (nbytes,) = np.frombuffer(raw[:4], "<u4")
    extent = [int(v) for v in image.get("WholeExtent").split()]
    dims = (extent[1] + 1, extent[3] + 1, extent[5] + 1)
    origin = [float(v) for v in image.get("Origin").split()]
    spacing = [float(v) for v in image.get("Spacing").split()]
    return dims, origin, spacing, np.frombuffer(raw[4:4 + nbytes], "<f4")


# -- modes (tests/test_cli.py) ---------------------------------------------


@pytest.mark.parametrize("args,out_name,dims,lines", [
    (["box345.stl", "16", "1"], "box345_sdf_16x21x25.sdf", (16, 21, 25),
     ["Calculated grid: 16 x 21 x 25", "Match: OK"]),
    (["box345.stl", "12", "14", "16", "2", "1"], "box345_sdf_12x14x16.sdf",
     (12, 14, 16), ["Target grid: 12 x 14 x 16", "Match: OK"]),
    (["box345.obj", "0.5", "2"], "box345.sdf", (10, 12, 14),
     ["Grid spacing (dx): 0.5"]),
    (["box345_ascii.stl", "12"], "box345_ascii_sdf_12x15x19.sdf",
     (12, 15, 19), ["Calculated grid: 12 x 15 x 19"]),
    (["box345.obj", "0.4", "2"], "box345.sdf", (11, 14, 16), []),
])
def test_cli_modes(workdir, capsys, args, out_name, dims, lines):
    rc, out, err = run(capsys, *args)
    assert rc == 0, out + err
    for line in lines + ["Hardware: CPU", "Inside cells:",
                         f"Dimensions: {dims[0]} x {dims[1]} x {dims[2]}"]:
        assert line in out, line
    got_dims, bmin, data = read_sdf(workdir / out_name)
    assert got_dims == dims and data.size == np.prod(dims)
    assert (data < 0).any() and (data > 0).any()
    if args[0].endswith(".obj") and args[1] == "0.5":
        np.testing.assert_allclose(bmin, [-2, -2, -2], atol=1e-6)


# -- errors (tests/test_cli.py TestCLIErrors) ------------------------------


@pytest.mark.parametrize("args,text", [
    ([], "Mode 1: Legacy OBJ"),
    (["box345.obj"], "Mode 2a"),
    (["nope.stl", "16", "1"], ""),
    (["bad.txt", "32", "1"], ""),
    (["box345.stl", "-5"], "positive"),
    (["box345.stl", "0", "1"], "positive"),
    (["box345.stl", "not_a_number", "1"], "positive"),
    (["malformed.stl", "32", "1"], ""),
    (["malformed.obj", "0.1", "2"], ""),
    (["box345.txt", "0.5", "2"], "OBJ"),
    (["box345.obj", "abc", "1"], "positive"),
    (["box345.stl", "8", "8", "0", "1"], "positive"),
])
def test_cli_errors(workdir, capsys, args, text):
    (workdir / "bad.txt").write_text("This is not a mesh file\n")
    (workdir / "malformed.stl").write_bytes(b"INVALID STL DATA")
    (workdir / "malformed.obj").write_text("# no vertices, no faces\n")
    rc, out, err = run(capsys, *args)
    assert rc == 255
    assert text in out + err


def test_cli_negative_padding_clamps(workdir, capsys):
    rc, out, err = run(capsys, "box345.obj", "0.5", "-2")
    assert rc == 0, out + err
    assert "Padding: 1 cells" in out


@pytest.mark.parametrize("s", ["16", " 16", "+7", "-5", "12abc", "abc", "",
                               "3.9", "1e3", "-", " -0.5e-1x", ".5", "5.",
                               "0.1", "nan"])
def test_atoi_atof_as_jax(s):
    assert cli._atoi(s) == jcli._atoi(s)
    assert cli._atof(s) == jcli._atof(s)


# -- formats and outputs (tests/test_cli_formats.py) -----------------------


def test_binary_vs_ascii_stl_identical(workdir, capsys):
    assert run(capsys, "box345.stl", "16", "1")[0] == 0
    assert run(capsys, "box345_ascii.stl", "16", "1")[0] == 0
    d1, _, a1 = read_sdf(workdir / "box345_sdf_16x21x25.sdf")
    d2, _, a2 = read_sdf(workdir / "box345_ascii_sdf_16x21x25.sdf")
    assert d1 == d2
    np.testing.assert_array_equal(a1, a2)


def test_stl_auto_detection(workdir, capsys):
    shutil.copy(workdir / "box345_ascii.stl", workdir / "sniffme.stl")
    rc, out, err = run(capsys, "sniffme.stl", "12", "1")
    assert rc == 0, out + err
    assert next(workdir.glob("sniffme_sdf_*.sdf"), None) is not None


def test_file_overwrite_and_header(workdir, capsys):
    out_path = workdir / "box345_sdf_16x21x25.sdf"
    rc, out, _ = run(capsys, "box345.stl", "16", "1")
    assert rc == 0 and out_path.exists()
    dims, _, _ = read_sdf(out_path)
    assert f"Dimensions: {dims[0]} x {dims[1]} x {dims[2]}" in out
    first = out_path.read_bytes()
    out_path.write_bytes(b"garbage")
    assert run(capsys, "box345.stl", "16", "1")[0] == 0
    assert out_path.read_bytes() == first


def test_relative_subdir_input(workdir, capsys):
    sub = workdir / "meshes"
    sub.mkdir()
    shutil.copy(workdir / "box345.stl", sub)
    rc, out, err = run(capsys, os.path.join("meshes", "box345.stl"), "12", "1")
    assert rc == 0, out + err
    assert next(sub.glob("box345_sdf_*.sdf"), None) is not None


def test_cli_sdf_equals_jax_writer(workdir, capsys):
    """Same grid through the port's CLI and the JAX CLI: identical header,
    values to the dense bar."""
    assert run(capsys, "box345.stl", "16", "1")[0] == 0
    port = (workdir / "box345_sdf_16x21x25.sdf").read_bytes()
    assert jcli.main(["sdfgen-tpu", "box345.stl", "16", "1"]) == 0
    capsys.readouterr()
    ref = (workdir / "box345_sdf_16x21x25.sdf").read_bytes()
    assert port[:36] == ref[:36]
    np.testing.assert_allclose(np.frombuffer(port[36:], "<f4"),
                               np.frombuffer(ref[36:], "<f4"),
                               rtol=2e-6, atol=1e-6)


# -- the box goldens through the CLI ---------------------------------------


@pytest.mark.parametrize("name", BOX_GOLDENS)
def test_cli_box_golden(workdir, capsys, name):
    entry = MANIFEST[name]
    rc, out, err = run(capsys, entry["mesh"], *entry["cli_args"])
    assert rc == 0, out + err
    for line in entry["stdout"]:
        assert line in out, line
    assert f"to: {entry['reference_output_name']}" in out
    _, grid, _ = golden_grid(name)
    dims, _, data = read_sdf(workdir / entry["reference_output_name"])
    assert dims == grid.shape
    assert_golden_bars(data.reshape(dims), grid, entry)


# -- .vti output (tests/test_vti.py) ---------------------------------------


def test_vti_bytes_equal_jax_writer(tmp_path):
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(5, 7, 9)).astype(np.float32)
    write_vti(str(tmp_path / "p.vti"), phi, (0.5, -1.0, 2.0), 0.25,
              array_name="SDF values")
    jwrite_vti(str(tmp_path / "j.vti"), phi, (0.5, -1.0, 2.0), 0.25,
               array_name="SDF values")
    assert (tmp_path / "p.vti").read_bytes() == (tmp_path / "j.vti").read_bytes()
    dims, origin, spacing, payload = read_vti(str(tmp_path / "p.vti"))
    assert dims == (5, 7, 9)
    np.testing.assert_allclose(origin, [0.5, -1.0, 2.0])
    np.testing.assert_allclose(spacing, [0.25] * 3)
    # x-fastest point order: payload[i + ni*(j + nj*k)]
    np.testing.assert_array_equal(payload.reshape(9, 7, 5).transpose(2, 1, 0),
                                  phi)


@pytest.mark.parametrize("shape", [(4, 4), (4, 0, 4)])
def test_vti_rejects_bad_shapes(tmp_path, shape):
    with pytest.raises(ValueError):
        write_vti(str(tmp_path / "bad.vti"), np.zeros(shape, np.float32),
                  (0, 0, 0), 0.1)


@pytest.mark.parametrize("vti", ["1", "0"])
def test_cli_vti_switch(workdir, capsys, monkeypatch, vti):
    monkeypatch.setenv(cli.VTI_ENV, vti)
    rc, out, err = run(capsys, "box345.stl", "24", "1")
    assert rc == 0, out + err
    vti_path = workdir / "box345_sdf_24x31x39.vti"
    sdf_path = workdir / "box345_sdf_24x31x39.sdf"
    assert vti_path.exists() == (vti == "1")
    assert sdf_path.exists() == (vti == "0")
    if vti == "1":
        assert "Writing VTK output to:" in out
        dims, _, _, payload = read_vti(str(vti_path))
        assert dims == (24, 31, 39)
        assert f"Inside cells: {int((payload < 0).sum())} /" in out


# -- python -m: usage, exit codes, no silent CPU fallback -------------------


def test_subprocess_usage_and_cpu_run(tmp_path):
    r = run_subprocess([], tmp_path)
    assert r.returncode == 255 and "Mode 2a" in r.stdout
    assert "Traceback" not in r.stderr
    shutil.copy(os.path.join(RESOURCES, "box345.stl"), tmp_path)
    r = run_subprocess(["box345.stl", "12", "1"], tmp_path, backend="cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Hardware: CPU" in r.stdout and "Processing complete." in r.stdout
    assert (tmp_path / "box345_sdf_12x15x19.sdf").exists()
    r = run_subprocess(["missing.stl", "12", "1"], tmp_path, backend="cpu")
    assert r.returncode == 255 and "Traceback" not in r.stderr


@pytest.mark.parametrize("backend,text", [(None, "CUDA"), ("gpu", "CUDA"),
                                          ("tpu", "Invalid backend")])
def test_subprocess_refuses_without_device(tmp_path, backend, text):
    if backend != "tpu" and torch.cuda.is_available():
        pytest.skip("this machine has CUDA: auto/gpu would run on it")
    shutil.copy(os.path.join(RESOURCES, "box345.stl"), tmp_path)
    r = run_subprocess(["box345.stl", "12", "1"], tmp_path, backend=backend)
    assert r.returncode == 255
    assert text in r.stderr and "Traceback" not in r.stderr
    assert not (tmp_path / "box345_sdf_12x15x19.sdf").exists()
