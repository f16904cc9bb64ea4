"""The port's host C++ helpers (``rtpe_tpu_torch/native``) against the
JAX package's, on the CPU.

JAX's library is built here by JAX's own ``build()`` from JAX's own
sources, copied to a temporary directory (its ``__file__`` pointed
there for the build), so that ``rtpe_tpu/native/`` is never written;
where ``g++`` is missing that comparison skips.

* the resize equals JAX's ``native_bilinear_resize`` bitwise, and stays
  within 1e-6 of ``resize_bilinear_np``, with ``align_corners`` on and
  off, at size 1 in and out and at equal shapes;
* the RLE decode and encode round-trip, and decode as JAX's
  ``rle_decode`` does, on random masks and on the polygon masks of
  ``_make_coco_fixture``;
* ``lap_solve`` gives JAX's native columns on random and tied costs, and
  scipy's optimal cost;
* with the library unavailable the fallbacks run, and warn once;
* four builds at once leave one loadable library and no temporary file;
* the port never writes under ``rtpe_tpu/native/``.

:func:`same_solver` is the fixture the host-grouping tests use: both
packages on their native solvers where both libraries load, both on
scipy otherwise.
"""

import atexit
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from test_data_eval import _make_coco_fixture

import rtpe_tpu.native as j_native
from rtpe_tpu.data import rle as j_rle
from rtpe_tpu.decode import group as j_group
from rtpe_tpu_torch import native
from rtpe_tpu_torch.data import dataset, rle
from rtpe_tpu_torch.decode import group as p_group
from rtpe_tpu_torch.ops.resize import resize_bilinear_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_NATIVE_DIR = os.path.dirname(os.path.abspath(j_native.__file__))
_JAX_LIB = {}


def jax_native_lib():
    """JAX's library, built once a process by ``rtpe_tpu.native.build``
    from copies of its sources in a temporary directory; None without
    ``g++``."""
    if "lib" not in _JAX_LIB:
        tmp = tempfile.mkdtemp(prefix="jax_native_")
        atexit.register(shutil.rmtree, tmp, True)
        for f in os.listdir(J_NATIVE_DIR):
            if f.endswith(".cpp"):
                shutil.copy(os.path.join(J_NATIVE_DIR, f), tmp)
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(j_native, "__file__", os.path.join(tmp, "__init__.py"))
            mp.setattr(j_native, "_LIB", None)
            mp.setattr(j_native, "_LIB_TRIED", False)
            _JAX_LIB["lib"] = j_native._load_lib() if j_native.build() \
                else None
        finally:
            mp.undo()
    return _JAX_LIB["lib"]


@pytest.fixture
def jax_lib(monkeypatch):
    """JAX's native functions served by its library built from its own
    sources; skips where it does not build."""
    lib = jax_native_lib()
    if lib is None:
        pytest.skip("g++ did not build JAX's native library here")
    monkeypatch.setattr(j_native, "_LIB", lib)
    monkeypatch.setattr(j_native, "_LIB_TRIED", True)
    return lib


def scipy_lap_solve(cost):
    return linear_sum_assignment(cost)


@pytest.fixture
def same_solver(monkeypatch):
    """Both host groupings on the same assignment solver: native against
    native where both libraries load, scipy against scipy otherwise (the
    two solvers may pair exact cost ties differently)."""
    lib = jax_native_lib()
    if lib is not None and native.available():
        monkeypatch.setattr(j_native, "_LIB", lib)
        monkeypatch.setattr(j_native, "_LIB_TRIED", True)
        return "native"
    monkeypatch.setattr(j_group, "lap_solve", scipy_lap_solve)
    monkeypatch.setattr(p_group, "lap_solve", scipy_lap_solve)
    return "scipy"


def test_the_port_builds_its_library_at_first_use():
    if shutil.which(native.CXX) is None:
        pytest.skip("no g++ here: the port falls back to numpy / scipy")
    assert native.available()
    assert os.path.dirname(native.lib_path()) == os.path.join(
        REPO, "rtpe_tpu_torch", "_build")
    assert os.path.exists(native.lib_path())
    assert sorted(native.SOURCES) == sorted(
        f for f in os.listdir(os.path.join(REPO, "rtpe_tpu_torch", "native"))
        if f.endswith(".cpp"))
    for src in native.SOURCES:
        with open(os.path.join(J_NATIVE_DIR, src)) as a, open(os.path.join(
                REPO, "rtpe_tpu_torch", "native", src)) as b:
            assert a.read() == b.read(), src


RESIZES = [((24, 32, 34), (96, 128)), ((5, 7, 3), (13, 4)),
           ((1, 1, 3), (5, 7)), ((6, 5, 2), (1, 1)), ((8, 9, 3), (8, 9)),
           ((1, 6, 2), (4, 6))]


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,out_hw", RESIZES)
def test_resize_bitwise_jax_and_close_to_numpy(shape, out_hw, align_corners,
                                              jax_lib):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    got = native.native_bilinear_resize(x, out_hw, align_corners)
    want = j_native.native_bilinear_resize(x, out_hw, align_corners)
    assert got.dtype == np.float32 and got.shape == (*out_hw, shape[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, resize_bilinear_np(x, out_hw, align_corners), rtol=0,
        atol=1e-6)


def _fixture_masks(tmp_path):
    _make_coco_fixture(str(tmp_path), n_imgs=4, hw=(96, 128),
                       jitter_per_image=True)
    with open(os.path.join(tmp_path, "annotations",
                           "person_keypoints_val2017.json")) as f:
        data = json.load(f)
    return [rle.polygons_to_mask(a["segmentation"], 96, 128)
            for a in data["annotations"]]


def test_rle_codec_round_trips_and_decodes_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    masks = [(rng.rand(41, 61) > p).astype(np.uint8) for p in
             (0.05, 0.55, 0.97)]
    masks += [np.zeros((7, 5), np.uint8), np.ones((7, 5), np.uint8)]
    masks += _fixture_masks(tmp_path)
    assert len(masks) > 6 and any(m.any() for m in masks[5:])
    for m in masks:
        h, w = m.shape
        enc = rle.rle_encode(m)
        assert enc == j_rle.rle_encode(m)
        got = native.native_rle_decode(enc["counts"].encode("ascii"), h, w)
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(rle.rle_decode(enc), m)
        np.testing.assert_array_equal(j_rle.rle_decode(enc), m)
        counts = native.native_rle_encode_counts(m)
        assert counts == rle.rle_encode(m, compress=False)["counts"]
        assert rle.decode_rle_counts(enc["counts"]) == counts


def _random_costs(rng):
    costs = [rng.random((k, k)) * 10 for k in (1, 2, 5, 17, 30)]
    # rounded costs tie exactly, as the grouping's round(dist) * 100 do
    costs += [np.round(rng.random((k, k)) * 3) * 100 for k in (4, 12, 30)]
    costs += [np.zeros((6, 6)), np.full((3, 3), 7.0)]
    return costs


def test_lap_solve_matches_jax_and_scipy(jax_lib):
    for cost in _random_costs(np.random.default_rng(1)):
        rows, cols = native.lap_solve(cost)
        jrows, jcols = j_native.lap_solve(cost)
        np.testing.assert_array_equal(rows, np.arange(len(cost)))
        np.testing.assert_array_equal(cols, jcols)
        np.testing.assert_array_equal(rows, jrows)
        assert sorted(cols) == list(range(len(cost)))
        r, c = linear_sum_assignment(cost)
        assert cost[rows, cols].sum() == pytest.approx(cost[r, c].sum(),
                                                       abs=1e-9)


def test_munkres_assign_is_jax_s_on_the_same_solver(same_solver):
    rng = np.random.default_rng(2)
    for n, m in ((3, 7), (9, 4), (6, 6)):
        cost = np.round(rng.random((n, m)) * 4) * 100 - rng.random((n, m))
        np.testing.assert_array_equal(p_group.munkres_assign(cost),
                                      j_group.munkres_assign(cost))


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """The port's native module with no compiler and an empty build
    directory, its load state reset."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-rtpe")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", False)
    monkeypatch.setattr(native, "_WARNED", False)


def test_fallbacks_run_and_warn_once(no_library):
    x = np.random.default_rng(3).normal(size=(6, 8, 4)).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="fall back to numpy"):
        assert native.native_bilinear_resize(x, (12, 16)) is None
    assert not native.available()
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cost = np.random.default_rng(4).random((5, 5))
        rows, cols = native.lap_solve(cost)
        r, c = linear_sum_assignment(cost)
        np.testing.assert_array_equal(cols, c)
        np.testing.assert_array_equal(
            dataset._resize_bilinear_host(x, (12, 16)),
            resize_bilinear_np(x, (12, 16)))
        m = (np.random.default_rng(5).random((9, 11)) > 0.5).astype(np.uint8)
        assert native.native_rle_decode(b"12", 9, 11) is None
        assert native.native_rle_encode_counts(m) is None
        np.testing.assert_array_equal(rle.rle_decode(rle.rle_encode(m)), m)
    assert not os.listdir(native.BUILD_DIR)


_BUILD = """
import sys
from rtpe_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
sys.exit(0 if native.build() else 1)
"""


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    if shutil.which(native.CXX) is None:
        pytest.skip("no g++ here")
    out = str(tmp_path / "build")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, out], cwd=REPO,
                              env=env) for _ in range(4)]
    assert [p.wait(timeout=300) for p in procs] == [0] * 4
    assert os.listdir(out) == [native.LIB_NAME]
    lib = ctypes.CDLL(os.path.join(out, native.LIB_NAME))
    native._declare(lib)
    cost = np.ascontiguousarray(np.random.default_rng(6).random((4, 4)))
    rows, cols = np.arange(4, dtype=np.int32), np.zeros(4, np.int32)
    assert lib.lap_solve(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 4,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int))) == 0
    np.testing.assert_array_equal(cols, linear_sum_assignment(cost)[1])


def _jax_native_files():
    """``rtpe_tpu/native/``'s sources and module, with sizes and mtimes
    (JAX's own tests may build its library beside them meanwhile)."""
    return {f: (os.path.getsize(os.path.join(J_NATIVE_DIR, f)),
                os.path.getmtime(os.path.join(J_NATIVE_DIR, f)))
            for f in os.listdir(J_NATIVE_DIR)
            if f.endswith((".cpp", ".py"))}


def test_the_port_never_writes_jax_s_native_directory(monkeypatch,
                                                      tmp_path):
    before = _jax_native_files()
    outputs = []
    real_run = subprocess.run

    def recording_run(cmd, *a, **kw):
        outputs.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", recording_run)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", False)
    assert native.available() == (shutil.which(native.CXX) is not None)
    assert outputs and all(os.path.dirname(o) == native.BUILD_DIR
                           for o in outputs)
    native.lap_solve(np.eye(3))
    assert _jax_native_files() == before
