"""JAX-variables -> port state dict (the inverse of the JAX package's
torch-statedict importer, ``rtpe_tpu/io/torch_import.py``).

``state_dict_from_jax(variables_np, cfg)`` turns the JAX package's
``{"params": ..., "batch_stats": ...}`` tree (numpy leaves) for a
``PoseHigherHRNet`` into the state dict of
:class:`rtpe_tpu_torch.models.PoseHigherHRNet`, with the layout changes

* conv kernel       HWIO -> OIHW
* conv-transpose    (kh, kw, in, out) -> (in, out, kh, kw)
* BN scale/bias/mean/var -> weight/bias/running_mean/running_var

It is strict: every JAX leaf maps to one port key, every port key gets
a value, and every shape is checked.  The flax-path -> torch-key table
is this package's own copy.

``student_state_dict_from_jax(variables_np)`` does the same for a
student (``AttentionStudentSteps``): its module names follow the JAX
tree, the stem takes the teacher's names, and a Dense kernel ``(in,
out)`` becomes a Linear weight ``(out, in)``.

``folded_params_from_jax(folded_np, cfg)`` turns the JAX package's
BN-folded dict (``rtpe_tpu.models.hrnet_packed.fold_w48_params``: numpy,
HWIO kernels, ``(kh, kw, in, out)`` for the transposed conv) into the
port's serving dict (``rtpe_tpu_torch.models.hrnet_packed``).
"""

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.hrnet import HRNetConfig, PoseHigherHRNet
from ..models.hrnet_packed import PackedParams, serving_params

_LEAF_SUFFIXES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}


def strip_fp16_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    """Remove the ``"1."`` key prefix of the reference's fp16
    ``network_to_half`` Sequential wrapper."""
    if sd and all(k.startswith("1.") for k in sd):
        return {k[2:]: v for k, v in sd.items()}
    return dict(sd)


def _block_inner(parts: Tuple[str, ...]) -> str:
    name = parts[0]
    if name == "downsample_conv":
        return "downsample.0"
    if name == "downsample_bn":
        return "downsample.1"
    return name  # conv1/bn1/conv2/bn2/conv3/bn3


def _teacher_prefix(parts: Tuple[str, ...]) -> str:
    """Torch module prefix for a flax module path in PoseHigherHRNet."""
    head = parts[0]
    if re.fullmatch(r"conv1|bn1|conv2|bn2", head):
        return head
    m = re.fullmatch(r"layer1_(\d+)", head)
    if m:
        return f"layer1.{m.group(1)}." + _block_inner(parts[1:])
    m = re.fullmatch(r"transition(\d)_(\d+)_(conv|bn)", head)
    if m:
        t, i, kind = m.groups()
        return f"transition{t}.{i}.{0 if kind == 'conv' else 1}"
    m = re.fullmatch(r"transition(\d)_(\d+)_(\d+)_(conv|bn)", head)
    if m:
        t, i, j, kind = m.groups()
        return f"transition{t}.{i}.{j}.{0 if kind == 'conv' else 1}"
    m = re.fullmatch(r"stage(\d)_(\d+)", head)
    if m:
        s, mod = m.groups()
        inner = parts[1]
        mi = re.fullmatch(r"branch(\d+)_(\d+)", inner)
        if mi:
            i, j = mi.groups()
            return (f"stage{s}.{mod}.branches.{i}.{j}."
                    + _block_inner(parts[2:]))
        mi = re.fullmatch(r"fuse(\d+)_(\d+)_(conv|bn)", inner)
        if mi:
            i, j, kind = mi.groups()
            return (f"stage{s}.{mod}.fuse_layers.{i}.{j}."
                    f"{0 if kind == 'conv' else 1}")
        mi = re.fullmatch(r"fuse(\d+)_(\d+)_(\d+)_(conv|bn)", inner)
        if mi:
            i, j, k, kind = mi.groups()
            return (f"stage{s}.{mod}.fuse_layers.{i}.{j}.{k}."
                    f"{0 if kind == 'conv' else 1}")
        raise KeyError(f"unknown stage member {parts}")
    m = re.fullmatch(r"final_(\d+)", head)
    if m:
        return f"final_layers.{m.group(1)}"
    m = re.fullmatch(r"deconv(\d+)_tconv", head)
    if m:
        return f"deconv_layers.{m.group(1)}.0.0"
    m = re.fullmatch(r"deconv(\d+)_bn", head)
    if m:
        return f"deconv_layers.{m.group(1)}.0.1"
    m = re.fullmatch(r"deconv(\d+)_block(\d+)", head)
    if m:
        i, b = m.groups()
        return (f"deconv_layers.{i}.{int(b) + 1}.0."
                + _block_inner(parts[1:]))
    raise KeyError(f"unknown teacher module path {parts}")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert(arr: np.ndarray, leaf: str, is_tconv: bool) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        # (kh, kw, in, out) -> tconv (in, out, kh, kw) / conv OIHW
        return np.transpose(arr, (2, 3, 0, 1) if is_tconv else (3, 2, 0, 1))
    return arr


def state_dict_from_jax(variables_np: Mapping,
                        cfg: HRNetConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``PoseHigherHRNet(cfg)`` from the
    JAX package's variables (numpy or array-like leaves)."""
    with torch.device("meta"):
        template = PoseHigherHRNet(cfg).state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables_np):
        _collection, *mods, leaf = path
        if leaf not in _LEAF_SUFFIXES:
            raise KeyError(f"unknown leaf {path}")
        key = f"{_teacher_prefix(tuple(mods))}.{_LEAF_SUFFIXES[leaf]}"
        if key not in template:
            raise KeyError(f"{path} maps to {key}, which the port lacks")
        if key in out:
            raise KeyError(f"two JAX leaves map to {key}")
        arr = _convert(np.asarray(value, np.float32), leaf,
                       is_tconv="tconv" in mods[-1])
        if tuple(arr.shape) != tuple(template[key].shape):
            raise ValueError(f"shape mismatch at {path}: {arr.shape} vs "
                             f"port {tuple(template[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = [k for k in template
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"JAX variables lack {len(missing)} port keys, "
                       f"e.g. {missing[:5]}")
    for k in template:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long)
    return out


def _student_prefix(mods: Tuple[str, ...]) -> str:
    if mods[0] == "stem":
        return "stem." + _teacher_prefix(mods[1:])
    return ".".join(mods)


def student_state_dict_from_jax(variables_np: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a student from the JAX package's
    variables (numpy or array-like leaves): conv kernels HWIO -> OIHW,
    Dense kernels ``(in, out)`` -> ``(out, in)``, BN scale / bias / mean /
    var -> weight / bias / running_mean / running_var, and a zero
    ``num_batches_tracked`` beside each BN.  Load it with
    ``load_state_dict(strict=True)``, which checks every key and shape."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables_np):
        _collection, *mods, leaf = path
        if leaf not in _LEAF_SUFFIXES:
            raise KeyError(f"unknown leaf {path}")
        prefix = _student_prefix(tuple(mods))
        key = f"{prefix}.{_LEAF_SUFFIXES[leaf]}"
        if key in out:
            raise KeyError(f"two JAX leaves map to {key}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else _convert(arr, leaf, False)
        out[key] = torch.from_numpy(np.array(arr, np.float32))
        if leaf == "mean":
            out[f"{prefix}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    return out


def folded_params_from_jax(folded_np: Mapping[str, Tuple[object, object]],
                           cfg: HRNetConfig,
                           dtype: torch.dtype = torch.float32,
                           device="cpu") -> PackedParams:
    """The port's serving dict from JAX's dense BN-folded dict
    ``name -> (kernel, bias)`` under the same names: kernels HWIO ->
    OIHW, the transposed conv's ``(kh, kw, in, out)`` -> ``(in, out, kh,
    kw)``, then the dtype, the device and the stacked chains of
    :func:`rtpe_tpu_torch.models.hrnet_packed.serving_params`."""
    folded = {}
    for key, (kernel, bias) in folded_np.items():
        k = np.asarray(kernel, np.float32)
        k = np.transpose(k, (2, 3, 0, 1) if key.endswith("tconv")
                         else (3, 2, 0, 1))
        folded[key] = (torch.from_numpy(np.ascontiguousarray(k)),
                       torch.from_numpy(np.array(bias, np.float32)))
    return serving_params(folded, cfg, dtype, torch.device(device))
