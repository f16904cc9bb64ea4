"""Load the JAX package's serving artifact directory.

Port of ``rtpe_tpu/io/serving.py:load_serving_artifact`` (and
``_cfg_from_dict``).  The directory, as ``export_serving_artifact``
writes it, holds

* ``weights.npz``: the canonical variable tree, flat
  ``collection/path`` keys (``params/conv1/kernel``, ...);
* ``meta.json``: a format marker, the model config, the predictor's
  construction kwargs, and the weights file's sha256 and array count;
* ``act_scales.json`` for an int8 artifact.

The reader checks the marker, the model family, the sha256 and the
array count as the JAX one does, and rebuilds the nested variable tree
without flax; ``PosePredictor.from_artifact`` serves it through
``state_dict_from_jax``.  Every artifact loads, as in JAX: an int8 one
brings its activation scales in ``predictor_kwargs["act_scales"]``.
The predictor, not the loader, refuses the serving modes the port has
not yet (int8, flip test-time augmentation), so ``from_artifact(d,
int8=False)`` serves an int8 artifact's weights in float, as JAX does.
Writing an artifact (``export_serving_artifact``) waits (ROADMAP.md).
"""

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict

import numpy as np

from ..models.hrnet import HRNetConfig, StageCfg

_FORMAT = "rtpe_tpu-serving-artifact-v1"
_META = "meta.json"
_ACT_SCALES_FORMAT = "rtpe_tpu-act-scales-v1"


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


def _load_act_scales(path: str) -> Dict[str, float]:
    """An activation-scale file (``rtpe_tpu/models/hrnet_packed.py:
    save_act_scales`` format), checked for its marker and entry count."""
    with open(path) as f:
        payload = json.load(f)
    got = (payload.get("format") if isinstance(payload, dict)
           else type(payload).__name__)
    if got != _ACT_SCALES_FORMAT:
        raise ValueError(f"{path}: not an activation-scale file (expected "
                         f"format={_ACT_SCALES_FORMAT!r}, got {got!r})")
    scales = payload.get("scales")
    if not isinstance(scales, dict) \
            or len(scales) != payload.get("num_entries"):
        raise ValueError(f"{path}: truncated or inconsistent scale set")
    return {k: float(v) for k, v in scales.items()}


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
        pkw["act_scales"] = _load_act_scales(os.path.join(path, sfile))
    return ServingArtifact(cfg=_cfg_from_dict(meta["cfg"]),
                           variables=_unflatten(flat),
                           predictor_kwargs=pkw, meta=meta)
