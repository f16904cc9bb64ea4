"""The port's serving meshes and process-group helpers against the JAX
package, on the CPU (``parallel/``; the data-parallel trainer is
``test_torch_parallel_dp.py``).

* ``halo_conv`` (3x3, 5x5, stride 2) and ``sharded_stem_apply`` on 2 and 4
  CPU shards against JAX's on the conftest's 8-device CPU mesh, within
  JAX's own 1e-5.
* ``spatial_forward_w48`` on 2 and 4 shards of the small HigherHRNet of
  ``tests/test_spatial_stem.py`` against the port's unsharded folded
  forward (``packed_forward`` in float32, which ``test_torch_packed``
  holds to JAX) within 1e-5 of each output's largest magnitude, and its
  refusal of a height that does not divide by 32 n.  Against JAX's
  ``spatial_forward_w48`` only in a test marked ``slow`` (its XLA
  compile takes minutes).
* ``PosePredictor(spatial_mesh=...)``'s people against the dense port
  predictor's and JAX's dense predictor's at that setup, and the
  refused combinations; ``PosePredictor(mesh=...)``'s ``predict_batch``
  of 3 images on a 2-shard mesh (padded to 4) against JAX's predictor
  on a 2-device data mesh, both ``fused_decode=False`` on the same
  assignment solver, within 1e-4 (``test_torch_slice``'s host-grouping
  tolerance), and with the packed forward the unsharded packed
  predictor's people within 1e-5; with int8 the sharded forward is the
  int8 one at every batch size, as in JAX.
* ``dist.initialize``'s environment (JAX's names over torchrun's, an
  explicit rank 0, a no-op without variables), ``process_local_batch_
  slice``, ``make_multihost_mesh``, ``make_mesh``'s idle-device warning
  and ``shard_batch`` / ``replicate``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu.parallel import spatial as jsp
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.models.hrnet_packed import fold_w48_params, packed_forward
from rtpe_tpu_torch.parallel import dist as pdist
from rtpe_tpu_torch.parallel import make_mesh, replicate, shard_batch
from rtpe_tpu_torch.parallel.spatial import (halo_conv, sharded_stem_apply,
                                             spatial_forward_w48)
from test_torch_model import seeded_variables, small_cfgs
from test_torch_native import same_solver  # noqa: F401
from test_torch_slice import _assert_same_people

CPU = torch.device("cpu")
NUM_JOINTS = 5


def _cpu_mesh(n, axis="model"):
    return make_mesh(n_data=1 if axis == "model" else n,
                     n_model=n if axis == "model" else 1,
                     devices=[CPU] * n)


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]).reshape(1, n),
                   ("data", "model"))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2)])
def test_halo_conv_matches_jax(n, k, stride):
    rng = np.random.RandomState(k + stride)
    x = rng.rand(2, 32, 12, 6).astype(np.float32)
    w = rng.rand(k, k, 6, 8).astype(np.float32)
    want = jsp.halo_conv(jsp.shard_spatial(jnp.asarray(x), _jax_mesh(n)),
                         jnp.asarray(w), _jax_mesh(n), stride=stride)
    shards = halo_conv(_nchw(x), torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))), _cpu_mesh(n),
        stride=stride)
    assert len(shards) == n
    np.testing.assert_allclose(_nhwc(torch.cat(shards, 2)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def _stem_variables(rng):
    def bn(c):
        return ({"scale": rng.normal(1, .2, c).astype(np.float32),
                 "bias": rng.normal(0, .2, c).astype(np.float32)},
                {"mean": rng.normal(0, .2, c).astype(np.float32),
                 "var": rng.uniform(.5, 1.5, c).astype(np.float32)})

    (b1, s1), (b2, s2) = bn(64), bn(64)
    params = {"conv1": {"kernel": rng.normal(0, .2, (3, 3, 3, 64)).astype(
        np.float32)}, "conv2": {"kernel": rng.normal(
            0, .05, (3, 3, 64, 64)).astype(np.float32)},
        "bn1": b1, "bn2": b2}
    return {"params": params, "batch_stats": {"bn1": s1, "bn2": s2}}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_stem_apply_matches_jax(n):
    rng = np.random.default_rng(n)
    v = _stem_variables(rng)
    x = rng.normal(size=(1, 64, 24, 3)).astype(np.float32)
    want = jsp.sharded_stem_apply(v, jnp.asarray(x), _jax_mesh(n))
    p, s = v["params"], v["batch_stats"]
    sd = {"conv1.weight": p["conv1"]["kernel"].transpose(3, 2, 0, 1),
          "conv2.weight": p["conv2"]["kernel"].transpose(3, 2, 0, 1)}
    for b in ("bn1", "bn2"):
        sd.update({f"{b}.weight": p[b]["scale"], f"{b}.bias": p[b]["bias"],
                   f"{b}.running_mean": s[b]["mean"],
                   f"{b}.running_var": s[b]["var"]})
    sd = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}
    shards = sharded_stem_apply(sd, _nchw(x), _cpu_mesh(n))
    assert [t.shape[2] for t in shards] == [16 // n] * n
    np.testing.assert_allclose(_nhwc(torch.cat(shards, 2)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def small():
    """The small HigherHRNet of ``tests/test_spatial_stem.py`` with the
    seeded variables of ``test_torch_slice`` (whose decode margins that
    file asserts), as JAX variables and the port's folded weights."""
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    pred = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                  num_joints=NUM_JOINTS, input_size=128,
                                  fused_decode=False)
    fw = fold_w48_params(pred.model.state_dict(), tcfg)
    return jcfg, tcfg, variables, pred, fw


def _spatial_input():
    return torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 3, 128, 64)).astype(np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_forward_matches_the_unsharded_forward(small, n):
    _, tcfg, _, _, fw = small
    x = _spatial_input()
    want = packed_forward(fw, x, tcfg, torch.float32)
    got = spatial_forward_w48(fw, x, _cpu_mesh(n), tcfg)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    with pytest.raises(ValueError, match="must divide by 32"):
        spatial_forward_w48(fw, x[:, :, :96], _cpu_mesh(n), tcfg)


@pytest.mark.slow
def test_spatial_forward_matches_jax_spatial_forward(small):
    """Against JAX's ``spatial_forward_w48`` (a multi-minute XLA
    compile), 4 shards, relative L2 < 1e-4 as JAX's own test."""
    from rtpe_tpu.models.hrnet_packed import fold_w48_params as jfold

    jcfg, tcfg, variables, _, fw = small
    x = _spatial_input()
    want = jsp.spatial_forward_w48(jfold(variables, jcfg),
                                   jnp.asarray(_nhwc(x)), _jax_mesh(4), jcfg)
    got = spatial_forward_w48(fw, x, _cpu_mesh(4), tcfg)
    for w, g in zip(want, got):
        a, b = np.asarray(w, np.float32), _nhwc(g)
        assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-4


def _images(n, hw=(128, 128), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(n)]


def test_spatial_predictor_matches_dense_and_jax(small, same_solver):  # noqa: F811
    jcfg, tcfg, variables, dense, _ = small
    spatial = PosePredictor(dense.model, device="cpu",
                            num_joints=NUM_JOINTS, input_size=128,
                            fused_decode=False,
                            spatial_mesh=_cpu_mesh(2))
    assert spatial.dtype == torch.float32 and spatial.spatial_mesh
    jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                      num_joints=NUM_JOINTS, input_size=128,
                      fused_decode=False)
    for im in _images(2):
        got = spatial.predict(im)
        _assert_same_people(got, dense.predict(im), tol=1e-4)
        _assert_same_people(got, jp.predict(im), tol=1e-3)


def test_spatial_predictor_refusals(small):
    _, tcfg, _, dense, _ = small
    mesh = _cpu_mesh(2)
    kw = dict(device="cpu", num_joints=NUM_JOINTS)
    for extra in (dict(packed=True), dict(mesh=_cpu_mesh(2, "data")),
                  dict(packed=True, int8=True,
                       allow_synthetic_calibration=True)):
        with pytest.raises(ValueError, match="spatial_mesh"):
            PosePredictor(dense.model, spatial_mesh=mesh, **kw, **extra)
    with pytest.raises(ValueError, match="requires packed=True"):
        PosePredictor(dense.model, spatial_mesh=mesh, int8=True, **kw)
    # 64 rows after the resize do not divide by 32 * 4
    odd = PosePredictor(dense.model, spatial_mesh=_cpu_mesh(4),
                        input_size=64, **kw)
    with pytest.raises(ValueError, match="height 64 must divide by 32"):
        odd.predict(_images(1, (64, 64))[0])


def test_data_mesh_predict_batch_matches_jax(small, same_solver):  # noqa: F811
    """Three images pad to four over two shards; the padding row is
    dropped before the decode."""
    jcfg, tcfg, variables, dense, _ = small
    mesh = _cpu_mesh(2, "data")
    tp = PosePredictor(dense.model, device="cpu", num_joints=NUM_JOINTS,
                       input_size=128, fused_decode=False, mesh=mesh)
    seen = []
    orig = tp._replica_forward
    tp._replica_forward = lambda i, x: seen.append(x.shape[0]) or orig(i, x)
    jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                      num_joints=NUM_JOINTS, input_size=128,
                      fused_decode=False,
                      mesh=JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1),
                                   ("data", "model")))
    images = _images(3, (96, 128), seed=1)
    out_t = tp.predict_batch(images)
    assert seen == [2, 2]
    out_j = jp.predict_batch(images)
    assert len(out_t) == len(out_j) == 3
    for rt, rj in zip(out_t, out_j):
        _assert_same_people(rt, rj, tol=1e-4)
    # the packed forward over the mesh: the unsharded packed people
    kw = dict(device="cpu", num_joints=NUM_JOINTS, input_size=128,
              fused_decode=False, packed=True)
    sharded = PosePredictor(dense.model, mesh=mesh, **kw)
    plain = PosePredictor(dense.model, **kw)
    for rs, rp in zip(sharded.predict_batch(images),
                      plain.predict_batch(images)):
        _assert_same_people(rs, rp, tol=1e-5)


def test_data_mesh_runs_int8_unrouted_as_jax(small):
    """JAX's sharded forward is the int8 program at every batch size; the
    route to bf16 stays with the unsharded calls."""
    _, _, _, dense, _ = small
    pred = PosePredictor(dense.model, device="cpu", num_joints=NUM_JOINTS,
                         input_size=64, packed=True, int8=True,
                         allow_synthetic_calibration=True,
                         mesh=_cpu_mesh(2, "data"))
    assert pred.routes_to_bf16(1)
    assert pred._replicas[0]["conv1"].kernel is pred.int8_params[
        "conv1"].kernel
    assert len(pred.predict_batch(_images(1, (64, 64)))) == 1


def test_initialize_reads_the_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False and not calls      # single process
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert pdist.initialize(backend="gloo")
    assert calls[-1] == ("gloo", dict(init_method="tcp://127.0.0.1:1234",
                                      world_size=4, rank=3))
    # JAX's names win over torchrun's; an explicit rank 0 wins over both
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:99")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    pdist.initialize(backend="gloo")
    assert calls[-1][1] == dict(init_method="tcp://10.0.0.1:99",
                                world_size=2, rank=1)
    pdist.initialize(process_id=0, backend="gloo")
    assert calls[-1][1]["rank"] == 0


def test_process_slices_and_multihost_mesh(monkeypatch):
    assert pdist.process_local_batch_slice(8) == slice(0, 8)
    monkeypatch.setattr(pdist, "world_size", lambda group=None: 4)
    monkeypatch.setattr(pdist, "rank", lambda group=None: 2)
    assert pdist.process_local_batch_slice(8) == slice(4, 6)
    with pytest.raises(ValueError, match="split evenly"):
        pdist.process_local_batch_slice(6)
    mesh = pdist.make_multihost_mesh(n_model=2,
                                     devices_per_process=[CPU] * 4)
    assert mesh.axis_names == ("hosts", "data", "model")
    assert mesh.shape == {"hosts": 4, "data": 2, "model": 2}


def test_make_mesh_shard_batch_and_replicate():
    with pytest.warns(UserWarning, match="rest idle"):
        mesh = make_mesh(n_data=2, devices=[CPU] * 3)
    assert mesh.shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(n_data=4, devices=[CPU] * 3)
    x = torch.arange(12.).reshape(4, 3)
    out = shard_batch({"x": x, "y": [x[:, :1]]}, mesh)
    assert [t.tolist() for t in out["x"]] == [x[:2].tolist(), x[2:].tolist()]
    assert len(out["y"][0]) == 2
    with pytest.raises(ValueError, match="does not shard"):
        shard_batch(x[:3], mesh)
    m = torch.nn.Linear(2, 2)
    assert replicate(m, mesh) == [m, m]      # one device: one shared copy
    tree = replicate({"w": (x, 1)}, mesh)
    assert tree[0]["w"][0] is x and tree[1]["w"][1] == 1
