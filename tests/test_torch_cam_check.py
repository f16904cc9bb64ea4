"""The fused-CAM ops' float64 check (``rtpe_tpu_torch/tools/cam_check.py``)
on the CPU, where the plain versions stand for the kernels.

* The float64 evaluation of the plain versions is bitwise the float32 one
  on exact-sum inputs, with sums of |terms| that bound every output; the
  float32 default gives what an explicit float32 evaluation gives, in the
  kernels' dtypes.
* A float32 evaluation in another summation order (each image alone, its
  pixel sums added across images) passes the rule that the control
  (float32 plain - f64) sets, on random inputs with gates of both signs.
* Injected defects that the check refuses: a corner pixel's dx scaled by
  1.05 on exact sums; F3b with image 0's gate in its dx phase (the JAX
  kernel's slip, ``rtpe_tpu/ops/pallas_cam.py:507``); a pixel sum taken
  in bf16; the last ragged tile's pixels dropped.
* The mechanism at a small shape: where pre-activations tie at zero in
  float32 and not in float64, every element float32 puts past
  ``cam_check.OFF`` lies downstream of a mask that differs, and pinning
  float64's masks brings float32 within ``cam_check.PINNED_TOL``.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.ops import cam
from rtpe_tpu_torch.tools import cam_check

SHAPE = (2, 11, 13, 24, (1, 2, 3), 4)
RAGGED = (3, 13, 11, 16, (1, 2, 3, 4), 4)     # 2 x 2 tiles, the last 5 x 3
OPS = tuple(cam_check.OUTPUTS)
PIXEL_OPS = ("cam_f1_bwd", "cam_f2_bwd", "cam_f3_fwd", "cam_f3_bwd")
# each op's arguments by name (dils last), and those that are per image
ARGS = {"cam_f1_fwd": ("x", "kr", "kh"),
        "cam_f1_bwd": ("x", "kr", "kh", "dsr", "dsh", "dgap"),
        "cam_f2_fwd": ("x", "kh", "kt", "bnh"),
        "cam_f2_bwd": ("x", "kh", "kt", "bnh", "dst"),
        "cam_f3_fwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate"),
        "cam_f3_bwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate",
                       "g")}
PER_IMAGE = ("x", "dgap", "gate", "g")
IMAGE_OUTPUTS = ("gap", "dgate")              # reductions over one image


def _rows(s, n, rng, exact):
    """BN rows [mean, inv, scale, bias] per branch from the sums ``s``
    (2k, w) over n pixels: the batch statistics, or dyadic rows near
    them."""
    s = s.double().numpy()
    mean = s[0::2] / n
    var = np.maximum(s[1::2] / n - mean * mean, 0.0)
    if exact:
        mean = np.round(mean)
        inv = np.full_like(mean, 0.25)
        scale = 0.5 * rng.integers(1, 3, mean.shape)
        bias = rng.integers(-4, 5, mean.shape) / 8.0
    else:
        inv = 1.0 / np.sqrt(var + 1e-5)
        scale = 1.0 + 0.1 * rng.normal(size=mean.shape)
        bias = 0.1 * rng.normal(size=mean.shape)
    rows = np.stack([mean, inv, scale, bias], 1).reshape(-1, mean.shape[1])
    return torch.from_numpy(rows.astype(np.float32))


def _case(shape, seed, exact=False):
    """Every input of the six ops at ``shape``: x in [0, 1), weights
    N(0, 1/fan_in), BN rows from the batch statistics, gates of both
    signs, random cotangents; or with ``exact`` small integers, weights
    in {-1, 0, 1}, dyadic rows, gates and cotangents (every per-pixel
    value exact in float32)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    rng = np.random.default_rng(seed)

    def weight(shp, fan_in):
        if exact:
            return rng.integers(-1, 2, shp) * (rng.random(shp) < 0.15)
        return rng.normal(size=shp) / np.sqrt(fan_in)

    def t(a, bf=False):
        out = torch.from_numpy(np.asarray(a, np.float32))
        return out.to(torch.bfloat16) if bf else out

    x = rng.integers(-1, 2, (b, h, w, c)) if exact else rng.random(
        (b, h, w, c))
    k = {"x": t(x, True), "kr": t(weight((c, c), c), True),
         "kh": t(weight((nb, 3, 3, c, hc), 9 * c), True),
         "kt": t(weight((nb, hc, c), nb * hc), True), "dils": tuple(dils)}
    n = b * h * w
    s_r, s_h, _ = cam.cam_f1_fwd_plain(k["x"], k["kr"], k["kh"], dils)
    k["bnh"] = _rows(s_h, n, rng, exact)
    k["bnr"] = _rows(s_r, n, rng, exact)
    k["bnt"] = _rows(cam.cam_f2_fwd_plain(k["x"], k["kh"], k["kt"],
                                          k["bnh"], dils), n, rng, exact)
    if exact:
        def cot(shp):
            return rng.integers(-4, 5, shp) / 8.0
        gate = rng.integers(-8, 9, (b, c)) / 8.0
        g = rng.integers(-2, 3, (b, h, w, c))
    else:
        def cot(shp):
            return rng.normal(size=shp) * 1e-3
        gate = rng.normal(size=(b, c))
        g = rng.normal(size=(b, h, w, c))
    for name, shp in (("dsr", (2, c)), ("dsh", (2 * nb, hc)),
                      ("dgap", (b, c)), ("dst", (2, c))):
        k[name] = t(cot(shp))
    k["gate"], k["g"] = t(gate), t(g, True)
    return k


def _args(k, name, **over):
    return tuple(over.get(a, k[a]) for a in ARGS[name]) + (k["dils"],)


def _plain(name, args, **kw):
    return cam_check.as_tuple(getattr(cam, name + "_plain")(*args, **kw))


def _control(name, args):
    """The float32 controls and the float64 evaluation of op ``name``,
    each (outputs, masks) (on the CPU the two controls, TF32 off and on,
    are one)."""
    ctl, f64 = cam_check.evaluations(name, args)
    assert all(torch.equal(a, b) for a, b in zip(ctl[0][0], ctl[1][0]))
    return ctl, f64


@pytest.mark.parametrize("name", OPS)
def test_float64_equals_float32_on_exact_sums(name):
    k = _case(SHAPE, 7, exact=True)
    args = _args(k, name)
    before = getattr(cam, name + "_plain").calls
    out32 = _plain(name, args)
    assert getattr(cam, name + "_plain").calls == before + 1
    explicit = _plain(name, args, dtype=torch.float32)
    f64, terms = (cam_check.as_tuple(v) for v in getattr(
        cam, name + "_plain")(*args, dtype=torch.float64, terms=True))
    for o, a, e, r, t in zip(cam_check.OUTPUTS[name], out32, explicit, f64,
                             terms):
        assert torch.equal(a, e) and a.dtype == e.dtype, o
        assert a.dtype == (torch.bfloat16 if o in cam_check.PIXEL
                           else torch.float32), o
        assert r.dtype == a.dtype if o in cam_check.PIXEL else \
            r.dtype == torch.float64, o
        assert torch.equal(a.double(), r.double()), o
        assert t.dtype == torch.float64 and bool(torch.isfinite(t).all()), o
        assert bool((t >= r.double().abs()).all()), o
        assert bool((t > 0).any()), o
    ratios, faults = cam_check.exact_check(name, out32, out32, f64, terms,
                                           every_output_bitwise=True)
    assert not faults and all(v == 0.0 for v in ratios.values()), faults


def _split_by_image(name, k):
    """Op ``name`` evaluated in float32 one image at a time: per-pixel and
    per-image outputs stacked, pixel sums added across images, a
    summation order of its own; (outputs, masks)."""
    evs = [cam_check.evaluate(name, _args(
        k, name, **{a: k[a][i:i + 1] for a in PER_IMAGE}))
        for i in range(k["x"].shape[0])]
    parts = [e[0] for e in evs]
    masks = {m: torch.cat([e[1][m] for e in evs]) for m in evs[0][1]}
    out = []
    for j, o in enumerate(cam_check.OUTPUTS[name]):
        vals = [p[j] for p in parts]
        if o in cam_check.PIXEL or o in IMAGE_OUTPUTS:
            out.append(torch.cat(vals))
        else:
            acc = vals[0]
            for v in vals[1:]:
                acc = acc + v
            out.append(acc)
    return tuple(out), masks


@pytest.mark.parametrize("name", OPS)
def test_a_float32_evaluation_passes_the_rule(name):
    """Random inputs, gates of both signs, a ragged shape: float32 summed
    image by image stays within the limits the control sets, and so does
    the control itself."""
    k = _case(RAGGED, 11)
    assert bool((k["gate"] < 0).any() and (k["gate"] > 0).any())
    args = _args(k, name)
    ctl, f64 = _control(name, args)
    other = _split_by_image(name, k)
    if name != "cam_f3_fwd":                    # F3 sums over no pixels
        assert any(not torch.equal(a, b) for a, b in zip(other[0],
                                                          ctl[0][0]))
    res, faults = cam_check.random_check(name, args, other, ctl, f64)
    assert not faults, faults
    _, faults = cam_check.random_check(name, args, ctl[0], ctl, f64)
    assert not faults, faults
    if name in cam_check.SCRATCH:
        d = res["masks_differ"]
        assert d["kernel"] <= d["limit"], d
    for o, r in res["outputs"].items():
        lim = r.get("own_masks", r)["limit"]
        assert lim["worst"] <= (cam_check.STAT_TOL if name in cam_check.STATS
                                else cam_check.CAPS["worst"]), o
        assert lim["mean"] <= cam_check.CAPS["mean"], o
        assert lim["share"] <= cam_check.CAPS["share"], o


@pytest.mark.parametrize("name", PIXEL_OPS)
def test_check_refuses_a_corner_pixel_scaled(name):
    """One corner pixel's per-pixel output times 1.05 on exact sums: the
    exact check refuses it.  The limits the six ops were held to before
    the float64 check (worst 2^-2 and mean 2^-8 of max |plain|, at most
    1e-4 of the elements off by more than 2^-5) let it through: it is at
    most 5 % off, on one pixel's C channels, a share of at most 4.9e-6
    of the elements at the train step's B=16 x 113 x 113."""
    k = _case(SHAPE, 7, exact=True)
    args = _args(k, name)
    plain32 = _plain(name, args)
    f64, terms = (cam_check.as_tuple(v) for v in getattr(
        cam, name + "_plain")(*args, dtype=torch.float64, terms=True))
    bad = plain32[0].clone()
    bad[0, 0, 0] = (bad[0, 0, 0].float() * 1.05).to(bad.dtype)
    assert not torch.equal(bad, plain32[0])
    got = (bad,) + plain32[1:]
    _, faults = cam_check.exact_check(name, got, plain32, f64, terms)
    assert faults and all(" dx " in f or " out " in f for f in faults)
    old = cam_check.figures(bad, plain32[0])
    c = bad.shape[-1]
    assert old["worst"] <= cam_check.CAPS["worst"]
    assert old["mean"] <= cam_check.CAPS["mean"]
    assert old["share"] * bad.numel() <= c
    assert c / (16 * 113 * 113 * c) < cam_check.CAPS["share"]


def _residual_dx(k, gate):
    """The residual path's part of F3b's dx, bf16(dr) kr^T, with ``gate``
    in its mask (cam.py:_f3b's arithmetic)."""
    ev = cam._Eval()
    x32 = k["x"].float()
    c = x32.shape[-1]
    _, res, zr, _, _, _, y, _ = cam._f3_recompute(
        ev, x32, k["kr"], k["kh"], k["kt"], k["bnr"], k["bnh"], k["bnt"],
        k["dils"])
    pre = res + y * gate[:, None, None, :]
    zero = torch.zeros_like(pre)
    d_o = torch.where(pre > 0.0, k["g"].float(), zero)
    dzr = torch.where(zr > 0.0, d_o, zero)
    _, inv_r, scale_r, _ = cam._bn_rows(k["bnr"], 0, c)
    return cam._bf(dzr * (scale_r * inv_r)) @ k["kr"].float().t()


@pytest.mark.parametrize("exact", [False, True], ids=["random", "exact"])
def test_check_refuses_image0_gate_in_f3b_dx(exact):
    """The JAX kernel's slip: F3b's dx phase with image 0's gate for
    every image (rtpe_tpu/ops/pallas_cam.py:507), so every later image's
    residual dx follows image 0's mask."""
    k = _case(RAGGED, 13, exact=exact)
    name = "cam_f3_bwd"
    args = _args(k, name)
    ctl, f64 = _control(name, args)
    plain32 = ctl[0][0]
    gate0 = k["gate"][:1].expand_as(k["gate"])
    bad = (plain32[0].float() - _residual_dx(k, k["gate"])
           + _residual_dx(k, gate0)).to(torch.bfloat16)
    assert not torch.equal(bad[1:], plain32[0][1:])
    got = (bad,) + plain32[1:]
    if exact:
        f64, terms = (cam_check.as_tuple(v) for v in cam.cam_f3_bwd_plain(
            *args, dtype=torch.float64, terms=True))
        _, faults = cam_check.exact_check(name, got, plain32, f64, terms)
    else:
        # phase 0 wrote dr with image b's gate: the masks are right
        _, faults = cam_check.random_check(name, args, (got, ctl[0][1]),
                                           ctl, f64)
    assert faults and all(f.startswith(f"{name} dx") for f in faults)


def _bf16_pairwise(t):
    """Sums over dims 1, 2 of (B, H, W, C), pairwise, every partial sum
    rounded to bf16."""
    v = t.reshape(t.shape[0], -1, t.shape[-1]).to(torch.bfloat16)
    while v.shape[1] > 1:
        if v.shape[1] % 2:
            v = torch.cat([v, torch.zeros_like(v[:, :1])], 1)
        v = (v[:, 0::2].float() + v[:, 1::2].float()).to(torch.bfloat16)
    return v[:, 0].float()


@pytest.mark.parametrize("out", ["s_r", "gap"])
def test_check_refuses_a_pixel_sum_in_bf16(out):
    """F1's sums of bf16(x kr) over the batch, or of x per image (the
    gap), taken in bf16 on random inputs.  (On exact sums at this size
    every partial sum is an integer bf16 holds.)"""
    k = _case(RAGGED, 17)
    name = "cam_f1_fwd"
    args = _args(k, name)
    ctl, f64 = _control(name, args)
    plain32 = ctl[0][0]
    if out == "gap":
        got = plain32[:2] + (_bf16_pairwise(k["x"]),)
    else:
        rc = cam._bf(k["x"].float() @ k["kr"].float())
        s = torch.stack([_bf16_pairwise(rc).sum(0),
                         _bf16_pairwise(rc * rc).sum(0)])
        got = (s,) + plain32[1:]
    _, faults = cam_check.random_check(name, args, (got, None), ctl, f64)
    assert faults and all(f.startswith(f"{name} {out}") for f in faults)


def _last_tile(shape):
    """A (B, H, W, 1) mask of each image's last 8 x 8 tile (ragged)."""
    b, h, w = shape[:3]
    m = torch.zeros((b, h, w, 1), dtype=torch.bool)
    m[:, (h - 1) // 8 * 8:, (w - 1) // 8 * 8:] = True
    return m


@pytest.mark.parametrize("exact", [False, True], ids=["random", "exact"])
@pytest.mark.parametrize("name", ["cam_f3_fwd", "cam_f3_bwd"])
def test_check_refuses_the_last_ragged_tile_dropped(name, exact):
    """Each image's last tile (5 x 3 pixels at 13 x 11) dropped: its
    per-pixel outputs zero, and (F3b) its pixels missing from every
    reduction (their output cotangents zero)."""
    k = _case(RAGGED, 19, exact=exact)
    tile = _last_tile(RAGGED)
    args = _args(k, name)
    ctl, f64 = _control(name, args)
    plain32 = ctl[0][0]
    got, masks = ctl[0]
    if name == "cam_f3_bwd":
        got, masks = cam_check.evaluate(name, _args(
            k, name, g=k["g"].masked_fill(tile, 0)))
    got = (got[0].masked_fill(tile, 0),) + got[1:]
    assert not torch.equal(got[0], plain32[0])
    if exact:
        f64, terms = (cam_check.as_tuple(v) for v in getattr(
            cam, name + "_plain")(*args, dtype=torch.float64, terms=True))
        _, faults = cam_check.exact_check(name, got, plain32, f64, terms)
    else:
        _, faults = cam_check.random_check(name, args, (got, masks), ctl,
                                           f64)
    assert faults and any(f.startswith(f"{name} dx")
                          or f.startswith(f"{name} out") for f in faults)
    if name == "cam_f3_bwd":
        assert any(" dgate" in f or " dS" in f or " dk" in f for f in faults)


def _tie(v, rows, i, width, rng):
    """Bias rows of BN branch ``i`` that put the float32 pre-activation of
    one value of v (B, H, W, width) per channel at exactly 0: bias =
    -((c0 - mean) inv scale) in float32, c0 the value at a random pixel.
    In float64 those elements land a rounding off 0, of either sign."""
    mean, inv, scale, _ = cam._bn_rows(rows, i, width)
    flat = v.reshape(-1, width)
    c0 = flat[rng.integers(0, flat.shape[0], width), np.arange(width)]
    rows = rows.clone()
    rows[4 * i + 3] = -((c0 - mean.reshape(-1)) * inv.reshape(-1)
                        * scale.reshape(-1))
    return rows


def _tied_case(seed):
    """Random inputs whose pre-activations z_i, zr and zt tie at 0 in
    float32 on some elements of every channel."""
    k = _case(SHAPE, seed)
    rng = np.random.default_rng(seed)
    ev = cam._Eval()
    x32 = k["x"].float()
    hc = k["kh"].shape[-1]
    cs, _ = cam._branches(ev, x32, k["kh"], k["bnh"], k["dils"])
    for i, c in enumerate(cs):
        k["bnh"] = _tie(c, k["bnh"], i, hc, rng)
    c = x32.shape[-1]
    rc = cam._bf(x32 @ k["kr"].float())
    k["bnr"] = _tie(rc, k["bnr"], 0, c, rng)
    _, zs = cam._branches(ev, x32, k["kh"], k["bnh"], k["dils"])
    t_bf = cam._bf(cam._top(ev, zs, k["kt"]))
    k["bnt"] = _tie(t_bf, k["bnt"], 0, c, rng)
    return k


@pytest.mark.parametrize("name", cam_check.MASKED)
def test_mask_flips_explain_every_far_element(name):
    """Ties at 0 in float32 that float64 breaks: the masks differ, the
    float32 backwards put elements past OFF of max |f64| (the forward's
    ReLU is continuous there: none), each downstream of a differing mask,
    and float32 with float64's masks pinned comes within PINNED_TOL."""
    k = _tied_case(23)
    args = _args(k, name)
    ev32 = cam_check.evaluate(name, args)
    ev64 = cam_check.evaluate(name, args, torch.float64)
    fig, faults = cam_check.mechanism(
        name, args, ev32, ev64, cam_check.aligned(name, args, ev32, ev64,
                                                  False))
    assert not faults, faults
    assert sum(fig["masks_differ"].values()) > 0, fig
    if name != "cam_f3_fwd":
        assert sum(fig["far"].values()) > 0, fig
    assert all(v == 0 for v in fig["far_not_downstream"].values())
    assert max(fig["aligned_worst"].values()) <= cam_check.PINNED_TOL
    if name != "cam_f3_fwd":
        worst = max(cam_check.figures(a, r)["worst"]
                    for a, r in zip(ev32[0], ev64[0]))
        assert worst > max(fig["aligned_worst"].values())
    # the same with float32's masks pinned into float64
    fig, faults = cam_check.mechanism(
        name, args, ev32, ev64, cam_check.aligned(name, args, ev32, ev64))
    assert not faults and max(fig["aligned_worst"].values()) \
        <= cam_check.PINNED_TOL, faults


def test_mechanism_refuses_a_far_element_no_mask_explains():
    """F2b on random inputs, one pixel's dx moved by 0.2 of max |f64|:
    where no mask differs between float32 and float64, its C far
    elements lie downstream of none, and the check says so."""
    k = _case(SHAPE, 29)
    name = "cam_f2_bwd"
    args = _args(k, name)
    (out32, m32), ev64 = (cam_check.evaluate(name, args),
                          cam_check.evaluate(name, args, torch.float64))
    dx = out32[0].float()
    dx[1, 5, 6] += 0.2 * float(ev64[0][0].float().abs().max())
    ev = ((dx.to(torch.bfloat16),) + out32[1:], m32)
    fig, faults = cam_check.mechanism(name, args, ev, ev64,
                                      cam_check.aligned(name, args, ev, ev64))
    assert sum(fig["masks_differ"].values()) == 0, fig
    assert fig["far_not_downstream"]["dx"] == dx.shape[-1], fig
    assert any(f.startswith(f"{name} dx") for f in faults)


@pytest.mark.parametrize("name", cam_check.SCRATCH)
def test_kernel_masks_read_the_scratch_regions(name, monkeypatch):
    """kernel_masks reads each mask from its region of the backward's
    workspace (ops/cam.py:_SCRATCH, in carve order, each region 256-byte
    aligned): a workspace laid out so from the plain version's masks, a
    as the kernel writes it and dr, dt non-zero where zr, zt decide,
    gives those masks back."""
    k = _case(RAGGED, 31)
    args = _args(k, name)
    out, masks = cam_check.evaluate(name, args)
    dec = cam_check.decisive(name, args, masks)
    b, h, w, c, dils, hc = RAGGED
    plan = cam.tile_plan(name[4:6] + "b", b, h, w, c, dils, hc)
    x32 = k["x"].float()
    _, zs = cam._branches(cam._Eval(), x32, k["kh"], k["bnh"], dils)
    fill = {"a": cam._bf(torch.cat([torch.relu(z) for z in zs], -1)),
            "dr": dec.get("zr"), "dt": dec.get("zt")}
    _, regions = cam._SCRATCH[name]
    chunks = []
    for key, pitch in regions:
        v = torch.full((b, h, w, plan[pitch]), 7.0, dtype=torch.bfloat16)
        if key in fill and fill[key] is not None:
            v[..., :fill[key].shape[-1]] = fill[key].to(torch.bfloat16)
        raw = v.reshape(-1).view(torch.uint8)
        chunks.append(torch.cat([raw, torch.zeros(
            cam._up(raw.numel(), 256) - raw.numel(), dtype=torch.uint8)]))
    ws = torch.cat(chunks)
    monkeypatch.setitem(cam._SCRATCH, name,
                        (lambda *a: (out, ws), regions))
    got, km = cam_check.kernel_masks(name, args)
    assert got == out
    assert set(km) == set(dec)
    for key in dec:
        assert torch.equal(km[key], dec[key]), key
