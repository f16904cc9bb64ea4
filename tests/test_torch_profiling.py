"""``rtpe_tpu_torch.obs.profiling`` against ``rtpe_tpu.obs.profiling``, on
the CPU.

* ``flops_of`` and ``memory_analysis`` of a 128 x 128 float32 matmul
  equal JAX's on ``jax.jit(a @ b)`` (FLOPs, argument and output bytes);
  ``timeit``'s keys.
* An unpadded 3 x 3 convolution's FLOPs equal JAX's.  With padding XLA
  counts only the taps that fall inside the image and ``FlopCounterMode``
  every tap: the port's count is the full one.
* The packed forward of a narrow HigherHRNet: one count with the chains
  on and off, and for the int8, int8-act and float graphs.  The kernels
  do not run here, so each wrapper's report is held alone: under a count
  it adds exactly its plain version's count once (run on ``meta``
  copies, the plain version's ``.calls`` untouched), and the flag that
  gates the reports is down outside a count.
* ``compiled_flops``; ``trace`` writes a trace file.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu.obs import profiling as jprof
from rtpe_tpu_torch.models import PoseHigherHRNet, init_random_
from rtpe_tpu_torch.models import hrnet_packed as packed
from rtpe_tpu_torch.obs import profiling
from rtpe_tpu_torch.ops import _observe, blocks, cam, quant
from rtpe_tpu_torch.utils.summary import compiled_flops
from test_torch_cam import _args, _inputs, _torch
from test_torch_model import small_cfgs


def test_matmul_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(128, 128)).astype(np.float32)
            for _ in range(2))
    jf = jax.jit(lambda x, y: x @ y)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = jprof.flops_of(jf, ja, jb)
    assert want == 2 * 128 ** 3
    assert profiling.flops_of(torch.matmul, ta, tb) == want
    jmem = jprof.memory_analysis(jf, ja, jb)
    mem = profiling.memory_analysis(torch.matmul, ta, tb)
    assert set(mem) == set(jmem)
    for key in ("argument_bytes", "output_bytes"):
        assert mem[key] == jmem[key], key
    # the output is the matmul's only allocation, as in XLA's program
    assert mem["temp_bytes"] == jmem["temp_bytes"] == 0.0
    assert mem["generated_code_bytes"] == 0.0
    t = profiling.timeit(torch.matmul, ta, tb, warmup=1, iters=3)
    assert set(t) == set(jprof.timeit(jf, ja, jb, warmup=1, iters=3))
    assert 0 < t["min"] <= t["p50"] and t["min"] <= t["mean"]


def test_memory_analysis_counts_temporaries_and_nesting():
    x = torch.ones(64, 64)

    def fn(d):
        t = d["x"] * 2.0                 # a temporary of 16 KiB
        return {"sum": [t.sum(0)]}
    mem = profiling.memory_analysis(fn, {"x": x})
    assert mem["argument_bytes"] == x.nbytes
    assert mem["output_bytes"] == 64 * 4
    assert mem["temp_bytes"] >= x.nbytes
    assert profiling.memory_analysis(lambda: 1 / 0) is None
    assert profiling.flops_of(lambda: 1 / 0) is None


def test_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    counts = {}
    for pad in ("VALID", "SAME"):
        jf = jax.jit(lambda a, b, p=pad: jax.lax.conv_general_dilated(
            a, b, (1, 1), p, dimension_numbers=("NHWC", "HWIO", "NHWC")))
        counts[pad] = jprof.flops_of(jf, jnp.asarray(x), jnp.asarray(w))
    assert profiling.flops_of(F.conv2d, tx, tw) == counts["VALID"] \
        == 2 * 2 * 14 * 14 * 4 * 8 * 9
    full = profiling.flops_of(lambda a, b: F.conv2d(a, b, padding=1),
                              tx, tw)
    assert full == 2 * 2 * 16 * 16 * 4 * 8 * 9 > counts["SAME"]


@pytest.fixture(scope="module")
def narrow():
    _, cfg = small_cfgs(17)
    model = init_random_(PoseHigherHRNet(cfg), seed=4).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 64, 64)).astype(np.float32))
    pk = packed.pack_w48_params(model.state_dict(), cfg, torch.float32,
                                "cpu")
    scales = packed.calibrate_act_scales(pk, [x], cfg, torch.float32)
    return dict(cfg=cfg, model=model, x=x, pk=pk,
                pq=packed.quantize_packed(pk, scales))


def test_packed_forward_counts_agree(narrow):
    cfg, x = narrow["cfg"], narrow["x"]

    def count(pk, **kw):
        with torch.inference_mode():
            return profiling.flops_of(
                lambda: packed.packed_forward(pk, x, cfg, torch.float32,
                                              **kw))
    plain = count(narrow["pk"])
    assert plain and plain > 0
    assert count(narrow["pk"], pallas_chains=True) == plain
    assert count(narrow["pq"]) == plain
    assert count(narrow["pq"], int8_act=True) == plain
    with torch.inference_mode():
        assert profiling.flops_of(narrow["model"], x) == plain
    assert compiled_flops(narrow["model"], x) == plain


def _reports(narrow):
    """(name, plain version, arguments) of every wrapper that reports a
    count: the chain at a branch shape of the narrow model, ``qconv`` at
    one of its geometries, the six CAM ops."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 8, 8, 16)).astype(np.float32))
    wts = torch.from_numpy(rng.normal(size=(2, 2, 3, 3, 16, 16))
                           .astype(np.float32))
    out = [("basicblock_chain", blocks.basicblock_chain_plain,
            (x, wts, torch.zeros(2, 2, 16)))]
    q = narrow["pq"]["stage4_0/fuse0_3"]
    xq = torch.zeros((1, q.cin, 16, 16), dtype=torch.int8)
    out.append(("qconv", quant.qconv_int32_plain, (xq, q, 1, None)))
    b, h, w, c, dils, hc = 2, 9, 7, 12, (1, 2, 3), 3
    inp = _inputs(b, h, w, c, dils, hc, seed=5)
    for name, plain, names in (
            ("cam_f1_fwd", cam.cam_f1_fwd_plain, ("x", "kr", "kh")),
            ("cam_f1_bwd", cam.cam_f1_bwd_plain,
             ("x", "kr", "kh", "dsr", "dsh", "dgap")),
            ("cam_f2_fwd", cam.cam_f2_fwd_plain, ("x", "kh", "kt", "bnh")),
            ("cam_f2_bwd", cam.cam_f2_bwd_plain,
             ("x", "kh", "kt", "bnh", "dst")),
            ("cam_f3_fwd", cam.cam_f3_fwd_plain,
             ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate")),
            ("cam_f3_bwd", cam.cam_f3_bwd_plain,
             ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate", "g"))):
        out.append((name, plain, (*_args(inp, names, _torch), dils)))
    return out


def test_kernel_reports_count_their_plain_version(narrow):
    """A launch's report adds its plain version's count once: alone it
    equals the plain version's, beside the plain version it doubles it;
    the flag that gates the reports is down outside a count."""
    for name, plain, args in _reports(narrow):
        want = profiling.flops_of(plain, *args)
        assert want and want > 0, name
        calls = getattr(plain, "calls", None)
        got = profiling.flops_of(
            lambda: _observe.launched(name, args, (), plain))
        assert got == want, name
        assert getattr(plain, "calls", None) == calls, name

        def both():
            plain(*args)
            _observe.launched(name, args, (), plain)
        assert profiling.flops_of(both) == 2 * want, name
    assert not _observe.active


def test_trace_writes_a_file(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        assert "aten::mm" in f.read()
