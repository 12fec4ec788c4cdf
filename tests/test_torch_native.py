"""The port's runtime IO and scoring against the JAX package, and its C++
state-log writer (``phdslam_tpu_torch/runtime/native``) against its plain
version, on the CPU.

``runtime/io.py``'s loaders against JAX's on the shipped datasets, a
labeled file and edge cases; the C++ writer byte for byte against the
port's Python writer (the JAX package's, copied) on edge values, NaN map
weights included; OSPA against JAX's on point sets of every size order
and edge sets; the build: several processes building and loading at once
into an empty build root all succeed, and a source that does not compile
raises with the compiler's output.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import phdslam_tpu.runtime.io as jio
from phdslam_tpu.eval.ospa import ospa_distance as jax_ospa
from phdslam_tpu_torch.eval import ospa as tospa
from phdslam_tpu_torch.runtime import io as tio
from phdslam_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_sets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("data", ["data/ackerman", "data/dense", "data/cv"])
def test_loaders_match_jax(data):
    """The loaders against JAX's on the shipped datasets, bit for bit."""
    path = f"{data}/measurements.txt"
    same_sets(tio.load_measurements(path), jio.load_measurements(path))
    if os.path.exists(f"{data}/controls.txt"):
        path = f"{data}/controls.txt"
        c = tio.load_controls(path)
        np.testing.assert_array_equal(c, jio.load_controls(path))
        assert c.dtype == np.float32 and c.shape[1] == 2


def test_labeled_loader_matches_jax(tmp_path):
    """(range, bearing, label) triples, an empty scan, a ragged tail and
    a trailing empty line, as JAX's loader reads them."""
    p = tmp_path / "m.txt"
    p.write_text("% header\n1.0 0.5 0 2.0 -0.5 1 \n\n3.0 0.1 0 7.5\n"
                 "4.25e-1\t-2 1 \n\n")
    got = tio.load_measurements(str(p), labeled=True)
    assert [g.shape for g in got] == [(2, 3), (0, 3), (1, 3), (1, 3)]
    same_sets(got, jio.load_measurements(str(p), labeled=True))
    same_sets(tio.load_measurements(str(p)), jio.load_measurements(str(p)))


@pytest.mark.parametrize("text", [
    "h\n", "", "h\n1 2\n", "h\n0.1 0.2 0.3\n\n\n", "h\n1 2 x 3\n5 6",
    "h\n1e-45 3.4028235e38 -0.0 0.30000001192092896\n",
    "h\n 7 8 \r\n9 10\r\n"], ids=["header only", "empty", "no newline",
                                 "blank lines", "text stops a line",
                                 "float edges", "CRLF"])
def test_measurement_loader_edges_match_jax(tmp_path, text):
    p = tmp_path / "m.txt"
    p.write_bytes(text.encode())
    same_sets(tio.load_measurements(str(p)), jio.load_measurements(str(p)))


@pytest.mark.parametrize("text", [
    "h\n1.5 0.1\n2, -0.2\n3\n\n4 5 6\n", "h\n", "h\n1,2,3\n,4 5\n"],
    ids=["mixed", "header only", "commas"])
def test_control_loader_edges_match_jax(tmp_path, text):
    p = tmp_path / "c.txt"
    p.write_text(text)
    got, want = tio.load_controls(str(p)), jio.load_controls(str(p))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_loader_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        tio.load_measurements(str(tmp_path / "nope.txt"))


@pytest.mark.parametrize("case", ["phd", "cphd", "edge values",
                                  "nan map weights", "no maps"])
def test_write_state_log_matches_plain_writer(tmp_path, case):
    """The C++ writer byte for byte against the Python writer (append
    mode too): NaN of either sign, infinities, signed zeros, tiny and huge
    magnitudes and integers in %g, NaN map weights (skipped by both, as
    a weight that is not > 0), a map of no live component, none."""
    rng = np.random.default_rng(7)
    P, K, C = 5, 9, 6
    w = np.where(rng.uniform(size=K) < 0.6, rng.uniform(0, 2, K), 0.0)
    mean = rng.normal(0, 9, (K, 4))
    pose = rng.normal(0, 5, 6)
    lw = rng.normal(-2, 1, P)
    if case == "edge values":
        pose[:] = [np.nan, -np.nan, np.inf, -np.inf, -0.0, 1e-40]
        mean[0, :2] = [1e22, -123456789.0]
        lw[:3] = [1e-5, 100000.0, 1234567.0]
    if case == "nan map weights":
        w[:3] = [np.nan, -np.nan, 0.7]
        w[-1] = np.nan
    gm = (w.astype(np.float32), mean.astype(np.float32),
          rng.uniform(0.01, 3, (K, 4, 4)).astype(np.float32))
    maps = (None, None) if case == "no maps" else (gm, gm)
    args = (pose.astype(np.float32), *maps, lw.astype(np.float32),
            rng.normal(0, 5, (P, 6)).astype(np.float32),
            rng.integers(0, 10240, P).astype(np.int32),
            rng.normal(-3, 1, C + 1).astype(np.float32), C,
            1 if case == "cphd" else 0)
    for d in ("native", "plain"):
        (tmp_path / d).mkdir()
    for t in (3, 3):
        tio.write_state_log(str(tmp_path / "native"), t, *args)
        tio.write_state_log_reference(str(tmp_path / "plain"), t, *args)
    name = "state_estimate00003.log"
    got = (tmp_path / "native" / name).read_bytes()
    assert got == (tmp_path / "plain" / name).read_bytes()
    assert got.count(b"\n") == 14      # 7 lines, written twice


@pytest.mark.parametrize("m,n", [(6, 9), (9, 6), (5, 5), (0, 4), (4, 0),
                                 (0, 0), (1, 1), (20, 45)])
def test_ospa_matches_jax(m, n):
    """OSPA(1, 5) and OSPA(2, 10) equal the JAX package's on random point
    sets of either size order and empty ones."""
    rng = np.random.default_rng(11 + m + 7 * n)
    X, Y = rng.uniform(0, 20, (m, 2)), rng.uniform(0, 20, (n, 2))
    for p, c in ((1, 5), (2, 10)):
        np.testing.assert_allclose(tospa.ospa_distance(X, Y, p=p, c=c),
                                   jax_ospa(X, Y, p=p, c=c), rtol=1e-12)


@pytest.mark.parametrize("case", ["coincident", "all beyond c", "ties"])
def test_ospa_edge_sets_match_jax(case):
    """Coincident points, every distance clipped at c, and equal-cost
    assignments: OSPA equals the JAX package's."""
    X = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    Y = {"coincident": np.repeat(X[:1], 4, axis=0),
         "all beyond c": X + 100.0,
         "ties": np.array([[0.5, 0.5], [0.5, 0.5], [-0.5, -0.5]])}[case]
    np.testing.assert_allclose(tospa.ospa_distance(X, Y, p=1, c=5),
                               jax_ospa(X, Y, p=1, c=5), rtol=1e-12)


def test_concurrent_builds_all_load(tmp_path):
    """Six processes build and load the writer at once into one empty
    build root: every one succeeds and writes its line, and one library
    remains."""
    code = ("import sys\n"
            "from phdslam_tpu_torch.runtime import native\n"
            "path = sys.argv[1] + '/log' + sys.argv[2]\n"
            "native.write_lines(path, [(native.LINE_G, [0.5, 2])],"
            " sys.argv[1])\n"
            "assert open(path).read() == '0.5 2 \\n'\n"
            "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               str(i)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    # the hash directory holds the library and no private build directory
    assert [p.name for p in (tmp_path / "native").glob("*/*")] \
        == ["libtextio.so"]


def test_failed_build_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.compile_library(src, tmp_path / "out" / "libbroken.so")
    assert not (tmp_path / "out" / "libbroken.so").exists()
