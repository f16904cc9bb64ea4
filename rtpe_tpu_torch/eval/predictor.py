"""High-level inference API: image in, people in image coordinates out.

Port of ``rtpe_tpu/eval/predictor.py``: resize-align + normalize on the
device, the W48 forward (bf16 on CUDA; with ``packed=True`` the
BN-folded serving forward of ``models/hrnet_packed.py``), the tag-map
resize, the decode, then the inverse transform on the host.  The decode
is the batched device decode (:meth:`HeatmapParser.parse_fused_batch`:
the NMS + top-k and lockstep grouping kernels on CUDA) or, with
``fused_decode=False``, the host-grouping decode
(:meth:`HeatmapParser.parse_batch`: the NMS + top-k kernel, munkres
grouping on the host, the refine on the device).
"""

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.preprocess import (get_final_preds, normalize_image,
                               resize_align_multi_scale)
from ..decode import HeatmapParser
from ..device import DeviceLike, default_dtype, resolve_device
from ..io.jax_import import state_dict_from_jax, strip_fp16_prefix
from ..io.serving import load_serving_artifact
from ..models.hrnet import HRNetConfig, PoseHigherHRNet
from ..models.hrnet_packed import pack_w48_params, packed_forward
from ..ops.resize import resize_bilinear

People = Tuple[List[np.ndarray], List[float]]

# options of the JAX predictor that later slices of the port bring
_LATER = {
    "int8": "the int8 serving modes (ROADMAP.md Queue 1 item 5)",
    "int8_act": "the int8 serving modes (ROADMAP.md Queue 1 item 5)",
    "act_scales": "the int8 serving modes (ROADMAP.md Queue 1 item 5)",
    "with_flip": "test-time augmentation (ROADMAP.md Queue 1 item 6)",
    "mesh": "data-parallel serving (ROADMAP.md Queue 1 item 9)",
    "spatial_mesh": "spatially sharded serving (ROADMAP.md Queue 1 "
                    "item 9)",
}


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
                 act_scales: Optional[Mapping[str, float]] = None,
                 mesh=None, spatial_mesh=None):
        later = dict(int8=int8, int8_act=int8_act, act_scales=act_scales,
                     with_flip=with_flip, mesh=mesh,
                     spatial_mesh=spatial_mesh)
        for name, value in later.items():
            if value not in (False, None):
                raise NotImplementedError(
                    f"{name} needs {_LATER[name]}, which a later slice of "
                    "the port brings")
        if tuple(scales) != (1.0,):
            raise NotImplementedError(
                f"scales={tuple(scales)} needs {_LATER['with_flip']}, "
                "which a later slice of the port brings")
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
        if self.packed:
            self.packed_params = pack_w48_params(
                model.state_dict(), model.cfg, self.dtype, self.device)
            self.model = model.eval()
            return
        model = model.to(self.device).eval().set_compute_dtype(self.dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model

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

    def _forward(self, batch_nhwc: torch.Tensor):
        x = batch_nhwc.permute(0, 3, 1, 2)
        if self.packed:
            return packed_forward(self.packed_params, x, self.model.cfg,
                                  self.dtype)
        return self.model(x)

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
            hms, tags = self._decode_outputs(*self._forward(x[None]))
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
        hms, tags = self._decode_outputs(*self._forward(x[None]))
        return self._decode_one(hms, tags, center, scale)
