"""The serving artifact directory, written and read as the JAX package
does.

Port of ``rtpe_tpu/io/serving.py``.  The directory holds

* ``weights.npz``: the canonical variable tree, flat
  ``collection/path`` keys (``params/conv1/kernel``, ...);
* ``meta.json``: a format marker, the model config, the predictor's
  construction kwargs, and the weights file's sha256 and array count;
* ``act_scales.json`` for an int8 artifact.

:func:`export_serving_artifact` writes it with the JAX function's
refusals (an int8 artifact must ship its scales); the variable tree
comes from the port's state dict through
``io/jax_import.py:jax_variables_from_state_dict``, so either package
serves what the other wrote.  The reader checks the marker, the model
family, the sha256 and the array count as the JAX one does, and
rebuilds the nested variable tree without flax;
``PosePredictor.from_artifact`` serves it through
``state_dict_from_jax``, an int8 artifact as int8 with its scales
(``predictor_kwargs["act_scales"]``), and ``from_artifact(d,
int8=False)`` serves its weights in float, as JAX does.
"""

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from ..models.hrnet import HRNetConfig, StageCfg, w48_config
from ..models.hrnet_packed import load_act_scales, save_act_scales
from .jax_import import _flatten

_FORMAT = "rtpe_tpu-serving-artifact-v1"
_WEIGHTS = "weights.npz"
_SCALES = "act_scales.json"
_META = "meta.json"


def _cfg_to_dict(cfg: HRNetConfig) -> Dict[str, Any]:
    """The model config as JSON-ready dicts (stages nested, tuples
    turned into lists by ``json``), as the JAX package writes it."""
    return dataclasses.asdict(cfg)


def _cfg_from_dict(d: Dict[str, Any]) -> HRNetConfig:
    def tup(v):
        return tuple(v) if isinstance(v, list) else v

    stages = ("stage2", "stage3", "stage4")
    kw = {k: tup(v) for k, v in d.items() if k not in stages}
    for s in stages:
        kw[s] = StageCfg(**{k: tup(v) for k, v in d[s].items()})
    return HRNetConfig(**kw)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def export_serving_artifact(out_dir: str, variables: Mapping,
                            cfg: Optional[HRNetConfig] = None, *,
                            num_joints: int = 17, input_size: int = 640,
                            packed: bool = True, int8: bool = False,
                            int8_act: bool = False,
                            act_scales: Union[Mapping[str, float], str,
                                              None] = None,
                            with_flip: bool = False,
                            scales: Sequence[float] = (1.0,),
                            extra_meta: Optional[Dict[str, Any]] = None
                            ) -> str:
    """Write a serving artifact directory that either package serves.

    :param variables: the JAX package's ``{"params", "batch_stats"}``
      tree of numpy leaves, e.g. from
      ``jax_variables_from_state_dict(model.state_dict(), cfg)``.
    :param act_scales: required with ``int8``: the calibrated scale set
      (``PosePredictor.act_scales``, ``calibrate_act_scales``) or a path
      to a scale file; an artifact never calibrates at load time.
    :returns: ``out_dir``.
    """
    cfg = cfg or w48_config()
    if int8_act and not int8:
        raise ValueError("int8_act=True requires int8=True")
    if int8 and not packed:
        raise ValueError("int8=True requires packed=True")
    if int8:
        if act_scales is None:
            raise ValueError(
                "int8 artifact without act_scales: calibrate first "
                "(calibrate_act_scales or PosePredictor(..., "
                "calibration_images=...).act_scales) — the artifact must "
                "ship validated scales, never re-calibrate at load time")
        if not isinstance(act_scales, Mapping):
            act_scales = load_act_scales(act_scales)
    elif act_scales is not None:
        raise ValueError("act_scales given but int8=False")

    os.makedirs(out_dir, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        if collection in variables:
            for path, val in _flatten(variables[collection]):
                flat["/".join((collection,) + path)] = np.asarray(val)
    if not any(k.startswith("params/") for k in flat):
        raise ValueError("variables has no 'params' collection")
    wpath = os.path.join(out_dir, _WEIGHTS)
    np.savez(wpath, **flat)      # uncompressed, as the JAX package writes
    if int8:
        save_act_scales(os.path.join(out_dir, _SCALES), act_scales)
    meta = {
        "format": _FORMAT,
        "model_family": "pose_higher_hrnet",
        "cfg": _cfg_to_dict(cfg),
        "predictor": {"num_joints": int(num_joints),
                      "input_size": int(input_size),
                      "packed": bool(packed), "int8": bool(int8),
                      "int8_act": bool(int8_act),
                      "with_flip": bool(with_flip),
                      "scales": [float(s) for s in scales]},
        "weights": {"file": _WEIGHTS, "num_arrays": len(flat),
                    "total_bytes": int(sum(a.nbytes for a in flat.values())),
                    "sha256": _sha256(wpath)},
        "act_scales_file": _SCALES if int8 else None,
    }
    if extra_meta:
        meta["extra"] = dict(extra_meta)
    tmp = os.path.join(out_dir, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, _META))
    return out_dir


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"params/a/b/kernel": arr}`` -> ``{"params": {"a": {"b":
    {"kernel": arr}}}}``."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


@dataclasses.dataclass
class ServingArtifact:
    """Loaded artifact: everything a serving process constructs from."""
    cfg: HRNetConfig
    variables: Dict[str, Any]
    predictor_kwargs: Dict[str, Any]
    meta: Dict[str, Any]


def load_serving_artifact(path: str) -> ServingArtifact:
    """Read and validate an artifact directory written by the JAX
    package's ``export_serving_artifact``; fails loudly on a foreign or
    truncated meta, a weights file whose sha256 or array count differs
    from the manifest, and on an int8 artifact without its scales."""
    mpath = os.path.join(path, _META)
    if not os.path.isfile(mpath):
        raise FileNotFoundError(
            f"{path}: no {_META} — not a serving artifact directory")
    with open(mpath) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or meta.get("format") != _FORMAT:
        got = (meta.get("format") if isinstance(meta, dict)
               else type(meta).__name__)
        raise ValueError(f"{mpath}: expected format={_FORMAT!r}, got {got!r}")
    if meta.get("model_family") != "pose_higher_hrnet":
        raise ValueError(f"{mpath}: unsupported model_family "
                         f"{meta.get('model_family')!r}")
    pkw = dict(meta["predictor"])
    wmeta = meta["weights"]
    wpath = os.path.join(path, wmeta["file"])
    got = _sha256(wpath)
    if got != wmeta["sha256"]:
        raise ValueError(f"{wpath}: sha256 mismatch (manifest "
                         f"{wmeta['sha256'][:12]}…, file {got[:12]}…) — "
                         "corrupt or tampered weights")
    with np.load(wpath) as z:
        flat = {k: z[k] for k in z.files}
    if len(flat) != wmeta["num_arrays"]:
        raise ValueError(f"{wpath}: {len(flat)} arrays, manifest says "
                         f"{wmeta['num_arrays']}")
    pkw["scales"] = tuple(float(s) for s in pkw.get("scales", [1.0]))
    if pkw.get("int8"):
        sfile = meta.get("act_scales_file")
        if not sfile:
            raise ValueError(f"{mpath}: int8 artifact without an "
                             "act_scales_file entry")
        pkw["act_scales"] = load_act_scales(os.path.join(path, sfile))
    return ServingArtifact(cfg=_cfg_from_dict(meta["cfg"]),
                           variables=_unflatten(flat),
                           predictor_kwargs=pkw, meta=meta)
