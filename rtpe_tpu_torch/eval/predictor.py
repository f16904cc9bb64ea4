"""High-level inference API: image in, people in image coordinates out.

Port of ``rtpe_tpu/eval/predictor.py``: resize-align + normalize on the
device, the W48 forward (bf16 on CUDA; with ``packed=True`` the
BN-folded serving forward of ``models/hrnet_packed.py``, with
``int8=True`` its int8 convs on ``csrc/qconv.cu``), the tag-map
resize (or, with ``with_flip`` / ``scales``, the test-time augmentation
of :func:`~rtpe_tpu_torch.eval.tta.tta_forward`), the decode, then the
inverse transform on the host.  The decode is the batched device
decode (:meth:`HeatmapParser.parse_fused_batch`: the NMS + top-k and
lockstep grouping kernels on CUDA) or, with ``fused_decode=False``, the
host-grouping decode (:meth:`HeatmapParser.parse_batch`: the NMS +
top-k kernel, munkres grouping on the host, the refine on the device).
"""

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.preprocess import (get_final_preds, normalize_image,
                               resize_align_multi_scale)
from ..decode import HeatmapParser
from ..device import DeviceLike, default_dtype, resolve_device
from ..io.jax_import import state_dict_from_jax, strip_fp16_prefix
from ..io.serving import load_serving_artifact
from ..models.hrnet import HRNetConfig, PoseHigherHRNet
from ..models.hrnet_packed import (calibrate_act_scales, conv_names,
                                   load_act_scales, pack_w48_params,
                                   packed_forward, quantize_packed)
from ..ops.resize import resize_bilinear
from .tta import tta_forward

People = Tuple[List[np.ndarray], List[float]]

# options of the JAX predictor that later slices of the port bring
_LATER = {
    "mesh": "data-parallel serving (ROADMAP.md Queue 1 item 6)",
    "spatial_mesh": "spatially sharded serving (ROADMAP.md Queue 1 "
                    "item 6)",
}

# Batches smaller than this are served through the bf16 packed params
# when int8 is on: the JAX predictor's default, the crossover measured on
# its TPU (rtpe_tpu/eval/predictor.py:40-47).  Kept so that both packages
# route alike; it suits the H100 too: there the int8 forward beats the
# bf16 one on the device at batch 8, while at batch 1 both are bound by
# their kernel launches on the host (PERF.md).
INT8_MIN_BATCH_DEFAULT = 8


def _to_unit_rgb(image) -> np.ndarray:
    """uint8 / 0-255 float / 0-1 float RGB -> float32 in [0, 1]
    (integers always divide by 255; floats only when their max > 1.5)."""
    arr = np.asarray(image)
    img = arr.astype(np.float32)
    if np.issubdtype(arr.dtype, np.integer) or img.max() > 1.5:
        img = img / 255.0
    return img


class PosePredictor:
    """Bottom-up multi-person pose inference with the W48 teacher head
    contract (coarse = heatmaps + tags at 1/4, refined = heatmaps at
    1/2).

    The predictor takes the module over: it moves it to ``device``, puts
    it in eval mode and casts its convolutions to ``dtype`` (default
    bf16 on CUDA, float32 on the CPU).  ``state_dict``, when given, is
    loaded first (the reference's fp16 ``"1."`` prefix is tolerated).

    ``packed=True`` folds BatchNorm into the weights once here
    (:func:`~rtpe_tpu_torch.models.hrnet_packed.pack_w48_params`, in
    ``dtype`` on ``device``) and serves every call through
    :func:`~rtpe_tpu_torch.models.hrnet_packed.packed_forward`, with the
    block chains on cuDNN as the JAX predictor serves them (it never
    sets ``pallas_chains``); the module itself then stays where it was.

    ``int8=True`` (with ``packed``) also quantizes the folded weights per
    channel to int8 with static activation scales
    (:func:`~rtpe_tpu_torch.models.hrnet_packed.quantize_packed`), and
    every quantized conv runs on the s8 kernel ``csrc/qconv.cu`` (its
    plain version on the CPU).  The scales come from ``act_scales`` (the
    dict of ``calibrate_act_scales``, or a path to a file of
    ``save_act_scales``; it must hold every conv), or are calibrated here
    on ``calibration_images`` (RGB in any range :meth:`predict` takes,
    normalized and resized to ``max(64, min(input_size, 320))`` squared)
    on the predictor's device and dtype; without either,
    ``allow_synthetic_calibration=True`` calibrates on one random
    normal batch (a ``torch.Generator`` seeded 0, which cannot draw
    JAX's ``PRNGKey(0)`` numbers).  ``self.act_scales`` is the set used.
    ``int8_act=True`` also stores the inter-layer activations int8.
    Shape groups of fewer than ``int8_min_batch`` images (default
    :data:`INT8_MIN_BATCH_DEFAULT`; 0 routes nothing) are served by the
    bf16 packed params kept beside the quantized ones; :meth:`predict`
    and :meth:`stream` count as batches of 1.  The JAX predictor's
    refusals and their exception types are kept.

    ``with_flip`` and ``scales`` (which must include 1.0) turn on the
    test-time augmentation: :meth:`predict` and :meth:`stream` run
    :func:`~rtpe_tpu_torch.eval.tta.tta_forward` (flip as a doubled
    batch, one forward per scale), and :meth:`predict_batch` serves its
    images one at a time through :meth:`predict`, as the JAX predictor
    does.
    """

    def __init__(self, model: PoseHigherHRNet,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device: DeviceLike = None, num_joints: int = 17,
                 input_size: int = 640,
                 parser: Optional[HeatmapParser] = None,
                 dtype: Optional[torch.dtype] = None,
                 scales: Sequence[float] = (1.0,),
                 fused_decode: Optional[bool] = None,
                 with_flip: bool = False, packed: bool = False,
                 int8: bool = False, int8_act: bool = False,
                 calibration_images: Optional[Sequence] = None,
                 allow_synthetic_calibration: bool = False,
                 act_scales: Union[Mapping[str, float], str, None] = None,
                 mesh=None, spatial_mesh=None,
                 int8_min_batch: Optional[int] = None):
        if int8 and not packed:
            raise ValueError("int8=True requires packed=True")
        if int8_act and not int8:
            raise ValueError("int8_act=True requires int8=True")
        if act_scales is not None and calibration_images is not None:
            raise ValueError(
                "act_scales and calibration_images are mutually "
                "exclusive: precomputed scales skip calibration")
        if int8 and calibration_images is None and act_scales is None \
                and not allow_synthetic_calibration:
            raise ValueError(
                "int8=True without calibration_images uses synthetic "
                "random-batch activation scales — unvalidated numerics."
                " Pass real calibration_images (or precomputed "
                "act_scales), or opt in explicitly with "
                "allow_synthetic_calibration=True")
        later = dict(mesh=mesh, spatial_mesh=spatial_mesh)
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name} needs {_LATER[name]}, which a later slice of "
                    "the port brings")
        self.with_flip = bool(with_flip)
        self.scales = tuple(scales)
        self.tta = self.with_flip or self.scales != (1.0,)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device, dtype)
        self.num_joints = num_joints
        self.input_size = input_size
        self.parser = parser or HeatmapParser(num_joints=num_joints)
        # None: the device decode on every device (on the CPU its plain
        # versions stand in for the card's kernels)
        self.fused_decode = fused_decode is not False
        if state_dict is not None:
            model.load_state_dict(strip_fp16_prefix(state_dict))
        self.packed = bool(packed)
        self.packed_params = None
        self.int8_params = None
        self.int8_act = bool(int8_act)
        self.act_scales = None
        self.int8_min_batch = int(INT8_MIN_BATCH_DEFAULT
                                  if int8_min_batch is None
                                  else int8_min_batch)
        if self.packed:
            self.packed_params = pack_w48_params(
                model.state_dict(), model.cfg, self.dtype, self.device)
            self.model = model.eval()
            if int8:
                scales_d = self._int8_scales(act_scales, calibration_images)
                self.act_scales = dict(scales_d)
                self.int8_params = quantize_packed(self.packed_params,
                                                   scales_d)
            return
        model = model.to(self.device).eval().set_compute_dtype(self.dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model

    def _int8_scales(self, act_scales, calibration_images
                     ) -> Mapping[str, float]:
        """The activation scales: given (a dict or a file, checked for
        every conv), or calibrated here."""
        names = conv_names(self.packed_params)
        if act_scales is not None:
            if not isinstance(act_scales, Mapping):
                act_scales = load_act_scales(act_scales)
            missing = [k for k in names if k not in act_scales]
            if missing:
                raise ValueError(
                    f"act_scales is missing {len(missing)} of {len(names)} "
                    f"conv entries (e.g. {missing[:3]}): scale file from a "
                    "different config or percentile run?")
            return act_scales
        hw = max(64, min(self.input_size, 320))
        if calibration_images is not None:
            calib = [resize_bilinear(
                normalize_image(torch.from_numpy(_to_unit_rgb(im)).to(
                    self.device))[None], (hw, hw), align_corners=False)
                for im in calibration_images]
        else:
            gen = torch.Generator().manual_seed(0)
            calib = [torch.randn((1, hw, hw, 3), generator=gen).to(
                self.device)]
        return calibrate_act_scales(
            self.packed_params, [x.permute(0, 3, 1, 2) for x in calib],
            self.model.cfg, self.dtype)

    @classmethod
    def from_jax(cls, variables_np: Mapping, cfg: HRNetConfig,
                 **kwargs) -> "PosePredictor":
        """Serve the JAX package's ``PoseHigherHRNet`` variables (numpy
        leaves) with the port."""
        return cls(PoseHigherHRNet(cfg), state_dict_from_jax(variables_np,
                                                             cfg), **kwargs)

    @classmethod
    def from_artifact(cls, path: str, **overrides) -> "PosePredictor":
        """Serve the JAX package's serving artifact directory
        (:func:`~rtpe_tpu_torch.io.serving.load_serving_artifact`): its
        weights, model config and predictor settings.  Keyword overrides
        win over the recorded settings (``packed=False`` serves the same
        weights through the canonical forward; ``int8=False`` serves an
        int8 artifact's weights in ``dtype`` and drops its scales, as in
        JAX; ``dtype=`` and ``device=`` as for the constructor).  The
        constructor refuses only what the merged settings ask for."""
        art = load_serving_artifact(path)
        kwargs = dict(art.predictor_kwargs)
        kwargs.update(overrides)
        if not kwargs.get("int8"):
            kwargs.pop("act_scales", None)
        return cls.from_jax(art.variables, art.cfg, **kwargs)

    # ------------------------------------------------------ shared path

    def _preprocess(self, image_rgb):
        """Image -> (normalized model input (h', w', 3) on the device,
        center, scale)."""
        img = _to_unit_rgb(image_rgb)
        resized, center, scale = resize_align_multi_scale(
            img * 255.0, self.input_size, 1, 1, device=self.device)
        return normalize_image(resized / 255.0), center, scale

    def routes_to_bf16(self, n: int) -> bool:
        """Whether a call of ``n`` images is served by the bf16 packed
        params although int8 is on (JAX's ``_route_fwd``)."""
        return self.int8_params is not None and n < self.int8_min_batch

    def _forward(self, batch_nhwc: torch.Tensor, n: Optional[int] = None):
        """The forward of a batch for a call of ``n`` user images (default
        the batch's size), which picks int8 or the bf16 route."""
        x = batch_nhwc.permute(0, 3, 1, 2)
        if not self.packed:
            return self.model(x)
        n = x.shape[0] if n is None else n
        if self.int8_params is None or self.routes_to_bf16(n):
            return packed_forward(self.packed_params, x, self.model.cfg,
                                  self.dtype)
        return packed_forward(self.int8_params, x, self.model.cfg,
                              self.dtype, int8_act=self.int8_act)

    def _forward_nhwc(self, batch_nhwc: torch.Tensor, n: int = 1):
        """The forward with NHWC heads (the TTA contract); a TTA batch
        serves one image, so it routes as a call of 1."""
        return tuple(t.permute(0, 2, 3, 1)
                     for t in self._forward(batch_nhwc, n))

    def _maps(self, batch_nhwc: torch.Tensor):
        """Model inputs -> NHWC (hms, tags) for the decode: the head
        outputs, or their TTA aggregate."""
        if self.tta:
            return tta_forward(self._forward_nhwc, batch_nhwc,
                               self.num_joints, self.with_flip, self.scales)
        return self._decode_outputs(*self._forward(batch_nhwc))

    def _parse(self, hms: torch.Tensor, tags: torch.Tensor):
        if self.fused_decode:
            return self.parser.parse_fused_batch(hms, tags)
        return self.parser.parse_batch(hms, tags, adjust=True, refine=True)

    def _decode_outputs(self, coarse, refined):
        """NCHW head outputs -> NHWC (hms, tags) at the refined
        resolution; each plane contiguous for the NMS kernel."""
        j = self.num_joints
        hms = refined[:, :j].to(torch.float32,
                                memory_format=torch.contiguous_format)
        tags = coarse[:, j:].to(torch.float32,
                                memory_format=torch.contiguous_format)
        hms = hms.permute(0, 2, 3, 1)
        tags = resize_bilinear(tags.permute(0, 2, 3, 1), hms.shape[1:3],
                               align_corners=True)
        return hms, tags

    def _finalize(self, grouped_i, scores_i, center, scale, hm_hw
                  ) -> People:
        people = [p for p in grouped_i if np.asarray(p).size > 0]
        hm_h, hm_w = hm_hw
        final = get_final_preds([people], center, scale, (hm_w, hm_h)) \
            if people else []
        return final, scores_i

    # ----------------------------------------------------------- public

    @torch.inference_mode()
    def predict_batch(self, images_rgb: Sequence[np.ndarray]
                      ) -> List[People]:
        """Batched inference: images are grouped by post-resize shape,
        and each group runs as one forward and one decode.

        :returns: one ``(people, scores)`` pair per input image.
        """
        if not images_rgb:
            return []
        if self.tta:
            # TTA composes per image, as in JAX
            return [self.predict(im) for im in images_rgb]
        pre = [self._preprocess(im) for im in images_rgb]
        groups = {}
        for i, (x, _, _) in enumerate(pre):
            groups.setdefault(tuple(x.shape), []).append(i)
        out: List = [None] * len(pre)
        for idxs in groups.values():
            batch = torch.stack([pre[i][0] for i in idxs])
            hms, tags = self._decode_outputs(*self._forward(batch))
            grouped, scores = self._parse(hms, tags)
            hm_hw = (int(hms.shape[1]), int(hms.shape[2]))
            for k, i in enumerate(idxs):
                out[i] = self._finalize(grouped[k], scores[k],
                                        pre[i][1], pre[i][2], hm_hw)
        return out

    @torch.inference_mode()
    def stream(self, images_rgb):
        """Pipelined streaming inference: yields one ``(people, scores)``
        per frame, in order.  The forward of frame N+1 is dispatched
        (CUDA launches are asynchronous) before frame N is decoded."""
        pending = None
        for im in images_rgb:
            x, center, scale = self._preprocess(im)
            hms, tags = self._maps(x[None])
            if pending is not None:
                yield self._decode_one(*pending)
            pending = (hms, tags, center, scale)
        if pending is not None:
            yield self._decode_one(*pending)

    def _decode_one(self, hms, tags, center, scale) -> People:
        grouped, scores = self._parse(hms, tags)
        return self._finalize(grouped[0], scores[0], center, scale,
                              (int(hms.shape[1]), int(hms.shape[2])))

    @torch.inference_mode()
    def predict(self, image_rgb: np.ndarray) -> People:
        """:param image_rgb: (H, W, 3) uint8/float RGB image.
        :returns: (people, scores) — each person a (J, >=3) array with
          x, y in ORIGINAL image coordinates plus the joint score.
        """
        x, center, scale = self._preprocess(image_rgb)
        hms, tags = self._maps(x[None])
        return self._decode_one(hms, tags, center, scale)
