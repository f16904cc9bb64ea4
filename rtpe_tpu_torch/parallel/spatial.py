"""Spatial activation sharding with halo exchange (port of
``rtpe_tpu/parallel/spatial.py``).

For inputs too large for one device's memory, the H dimension of every
activation is split over a mesh axis (``"model"`` by default).  A
sharded activation is a list of NCHW tensors, shard i on device i of
the axis.  A k x k convolution then needs k // 2 rows from each
neighbour: :func:`_exchange_halos` copies them to the shard's device
(``Tensor.to(..., non_blocking=True)``: a peer copy between cards, none
where the shards share a device), with zero rows at the outer edges,
which reproduces the unsharded 'same' convolution exactly.  JAX moves
the same rows with ``lax.ppermute`` inside ``shard_map``; here one
process drives every shard, as in JAX.  The convolutions are cuDNN's,
as they are XLA's in JAX.

Layouts are the port's: NCHW activations, OIHW weights, (in, out, kh,
kw) for the transposed conv.
"""

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.layers import BN_EPS
from .mesh import Mesh, gather_rows, replicate

Shards = List[torch.Tensor]


def _exchange_halos(xs: Shards, halo: int
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(top, bottom) halo rows of every shard: the last ``halo`` rows of
    the shard above and the first of the shard below, moved to this
    shard's device; zeros at the outer edges."""
    out = []
    for i, x in enumerate(xs):
        b, c, _, w = x.shape
        if i > 0:
            top = xs[i - 1][:, :, -halo:].to(x.device, non_blocking=True)
        else:
            top = x.new_zeros((b, c, halo, w))
        if i < len(xs) - 1:
            bot = xs[i + 1][:, :, :halo].to(x.device, non_blocking=True)
        else:
            bot = x.new_zeros((b, c, halo, w))
        out.append((top, bot))
    return out


def _haloed(xs: Shards, halo: int) -> Shards:
    if not halo:
        return list(xs)
    return [torch.cat([t, x, b], 2)
            for x, (t, b) in zip(xs, _exchange_halos(xs, halo))]


def shard_spatial(x: torch.Tensor, mesh: Mesh,
                  axis_name: str = "model") -> Shards:
    """An NCHW tensor -> its H shards, shard i on device i of
    ``axis_name``.  H must divide by the axis size."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    if x.shape[2] % n:
        raise ValueError(f"H={x.shape[2]} does not shard over {n} devices")
    m = x.shape[2] // n
    return [x[:, :, i * m:(i + 1) * m].to(d, non_blocking=True)
            for i, d in enumerate(devs)]


def _as_shards(x: Union[torch.Tensor, Shards], mesh: Mesh,
               axis_name: str) -> Shards:
    return shard_spatial(x, mesh, axis_name) if torch.is_tensor(x) \
        else list(x)


def halo_conv(x: Union[torch.Tensor, Shards], kernel: torch.Tensor,
              mesh: Mesh, axis_name: str = "model",
              stride: int = 1) -> Shards:
    """'Same'-padded convolution with H sharded over ``axis_name``.

    :param x: (B, C, H, W), or its shards (:func:`shard_spatial`).
    :param kernel: (C_out, C, kh, kw), kh odd.
    :returns: the (B, C_out, H/stride, W/stride) output's shards, in
      ``x``'s dtype.  Each shard's rows must divide by ``stride``."""
    xs = _as_shards(x, mesh, axis_name)
    kh, kw = kernel.shape[2:]
    xs = _haloed(xs, kh // 2)
    return [F.conv2d(xh, kernel.to(xh.device, xh.dtype), None, stride,
                     (0, kw // 2)) for xh in xs]


def _local_same_conv(xs: Shards, w: Sequence[torch.Tensor],
                     b: Sequence[torch.Tensor], stride: int = 1) -> Shards:
    """Shard-local 'same' conv plus bias (``w``, ``b``: one copy per
    shard).  Exact under stride 2 because every shard's global start
    row is even (the divisibility contract of
    :func:`spatial_forward_w48`)."""
    kh, kw = w[0].shape[2:]
    xs = _haloed(xs, kh // 2)
    return [F.conv2d(xh, wi, None, stride, (0, kw // 2))
            + bi[:, None, None] for xh, wi, bi in zip(xs, w, b)]


def _local_tconv4x4s2(xs: Shards, w: Sequence[torch.Tensor],
                      b: Sequence[torch.Tensor]) -> Shards:
    """torch ``ConvTranspose2d(k=4, s=2, p=1)`` on H-sharded rows: one
    halo row a side, and an H padding of 3 crops the transposed conv of
    the haloed rows to exactly this shard's 2 H_local output rows (the
    zero outer halos give the global edges)."""
    xs = _haloed(xs, 1)
    return [F.conv_transpose2d(xh, wi, None, 2, (3, 1))
            + bi[:, None, None] for xh, wi, bi in zip(xs, w, b)]


def spatial_forward_w48(fw, x: Union[torch.Tensor, Shards], mesh: Mesh,
                        cfg=None, axis_name: str = "model"):
    """The whole folded W48 forward in float32 with every activation
    H-sharded over ``axis_name``: the stem, every stage, branch and fuse
    layer (nearest upsampling and strided downsampling), and the
    cat-deconv head, with a halo exchange at each 3x3 and 4x4 conv.

    :param fw: the BN-folded float32 weights of
        :func:`~rtpe_tpu_torch.models.hrnet_packed.fold_w48_params`, or
        one copy per device of the axis (:func:`~.mesh.replicate`).
    :param x: (B, 3, H, W); H must divide by ``32 * n`` (n the axis
        size), so that every branch's rows shard evenly and each
        shard's row count is even.
    :returns: ``(coarse, refined)`` NCHW float32, the unsharded folded
        forward's values, gathered on the axis's first device.
    """
    from ..models.hrnet import w48_config

    cfg = cfg or w48_config()
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    h = x.shape[2] if torch.is_tensor(x) else sum(s.shape[2] for s in x)
    if h % (32 * n):
        raise ValueError(f"spatial_forward_w48: H={h} must divide by "
                         f"32*{n}")
    per = fw if isinstance(fw, list) else replicate(fw, mesh, axis_name)

    def wb(name):
        return [p[name][0] for p in per], [p[name][1] for p in per]

    def conv(v, name, stride=1, relu=False):
        y = _local_same_conv(v, *wb(name), stride)
        return [t.relu_() for t in y] if relu else y

    def add(a, b_):
        return [s + t for s, t in zip(a, b_)]

    def relu(v):
        return [torch.relu(t) for t in v]

    def basic_block(v, name):
        out = conv(v, f"{name}/conv1", relu=True)
        out = conv(out, f"{name}/conv2")
        return relu(add(out, v))

    def bottleneck(v, name):
        out = conv(v, f"{name}/conv1", relu=True)
        out = conv(out, f"{name}/conv2", relu=True)
        out = conv(out, f"{name}/conv3")
        res = (conv(v, f"{name}/downsample")
               if f"{name}/downsample" in per[0] else v)
        return relu(add(out, res))

    def module(pfx, scfg, xs, mso):
        nb = scfg.num_branches
        ys = []
        for i in range(nb):
            v = xs[i]
            for j in range(scfg.num_blocks[i]):
                v = basic_block(v, f"{pfx}/branch{i}_{j}")
            ys.append(v)
        if nb == 1:
            return ys
        fused = []
        for i in range(nb if mso else 1):
            acc = None
            for j in range(nb):
                if j == i:
                    y = ys[j]
                elif j > i:
                    y = conv(ys[j], f"{pfx}/fuse{i}_{j}")
                    y = [F.interpolate(t, scale_factor=2 ** (j - i),
                                       mode="nearest") for t in y]
                else:
                    y = ys[j]
                    for k in range(i - j):
                        y = conv(y, f"{pfx}/fuse{i}_{j}_{k}", stride=2,
                                 relu=k < i - j - 1)
                acc = y if acc is None else add(acc, y)
            fused.append(relu(acc))
        return fused

    xs0 = [s.float() for s in _as_shards(x, mesh, axis_name)]
    v = conv(xs0, "conv1", stride=2, relu=True)
    v = conv(v, "conv2", stride=2, relu=True)
    for i in range(4):
        v = bottleneck(v, f"layer1_{i}")
    xs = [conv(v, "transition1_0", relu=True),
          conv(v, "transition1_1_0", stride=2, relu=True)]
    for m in range(cfg.stage2.num_modules):
        xs = module(f"stage2_{m}", cfg.stage2, xs, True)
    xs.append(conv(xs[-1], "transition2_2_0", stride=2, relu=True))
    for m in range(cfg.stage3.num_modules):
        xs = module(f"stage3_{m}", cfg.stage3, xs, True)
    xs.append(conv(xs[-1], "transition3_3_0", stride=2, relu=True))
    for m in range(cfg.stage4.num_modules):
        xs = module(f"stage4_{m}", cfg.stage4, xs,
                    m < cfg.stage4.num_modules - 1)

    x0 = xs[0]
    y0 = conv(x0, "final_0")
    cat = [torch.cat([a, b_], 1) for a, b_ in zip(x0, y0)]
    xh = relu(_local_tconv4x4s2(cat, *wb("deconv0_tconv")))
    for blk in range(cfg.deconv_num_blocks):
        xh = basic_block(xh, f"deconv0_block{blk}")
    y1 = conv(xh, "final_1")
    return gather_rows(y0, devs[0], 2), gather_rows(y1, devs[0], 2)


def sharded_stem_apply(state_dict, x: Union[torch.Tensor, Shards],
                       mesh: Mesh, axis_name: str = "model") -> Shards:
    """The W48 teacher's stem (conv1-bn1-relu, conv2-bn2-relu; reference
    ``pose_higher_hrnet.py:362-370``) in float32 with H sharded over
    ``axis_name``: eval BN is per-channel, so only the two 3x3 stride-2
    convs exchange halos.

    :param state_dict: the teacher's (reference keys ``conv1.weight``,
        ``bn1.weight`` / ``bias`` / ``running_mean`` / ``running_var``,
        ...; the fp16 ``"1."`` prefix is stripped).
    :param x: (B, 3, H, W), H divisible by ``4 * n``, or its shards.
    :returns: the (B, 64, H/4, W/4) stem features' shards.
    """
    from ..io.jax_import import strip_fp16_prefix

    sd = strip_fp16_prefix(state_dict)
    xs = [s.float() for s in _as_shards(x, mesh, axis_name)]
    for conv_name, bn_name in (("conv1", "bn1"), ("conv2", "bn2")):
        xs = halo_conv(xs, sd[f"{conv_name}.weight"].float(), mesh,
                       axis_name, stride=2)
        out = []
        for t in xs:
            def p(k):
                return sd[f"{bn_name}.{k}"].to(t.device, torch.float32)[
                    :, None, None]
            g = p("weight") / torch.sqrt(p("running_var") + BN_EPS)
            out.append(torch.relu((t - p("running_mean")) * g + p("bias")))
        xs = out
    return xs

