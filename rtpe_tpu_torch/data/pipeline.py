"""Fixed-shape training pipeline, augmented on the device (port of
``rtpe_tpu/data/pipeline.py``).

The reference's data path is its biggest bottleneck: per-sample python
loading with ``num_workers=0`` and per-*channel* PIL augmentation replay
(``distillation.py:278-283``).  Here:

1. host: decode and pad every sample onto a fixed canvas (numpy only);
   with ``num_workers > 1`` a thread pool builds several batches at once
   (JPEG decode via cv2 and numpy release the GIL, so threads scale
   without pickling the host batches through process boundaries).  The
   host threads never touch CUDA;
2. upload: the consumer thread copies each host batch to the device in
   its compact dtypes (uint8 images and masks, float16 teacher maps) from
   page-locked buffers the workers filled, on a side stream, so the copy
   overlaps the previous step's kernels;
3. device: widen, convert to LAB or HSV, normalize, render the Gaussian
   targets from the joints, then warp *all* planes of the batch with one
   affine matrix per sample in a single batched
   :func:`~rtpe_tpu_torch.ops.affine.affine_warp`.

Every batch has identical shapes.  With ``num_workers > 1`` each batch
gets its own seed drawn up front, so the augmentation stream is
deterministic for a given pipeline seed regardless of worker count or
scheduling; ``num_workers=1`` draws sequentially from the pipeline's
``RandomState``.  Both streams are JAX's, draw for draw.
"""

import hashlib
import json
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.affine import affine_warp
from ..ops.color import rgb_to_hsv, rgb_to_lab
from .augment import AugmentConfig, sample_affine_matrices
from .preprocess import normalize_image
from .targets import render_heatmaps

MAX_PEOPLE = 30


def _augment_planes(imgs, masks, segms, teacher_hms, teacher_ae, joints,
                    sigmas: Tuple[float, ...],
                    alt_colorspace: str) -> torch.Tensor:
    """The planes of a batch before the warp, one (B, H, W, C) float32
    stack on the tensors' device: the normalized image, its LAB or HSV
    version, the two masks, a target set per sigma and the teacher maps.
    Takes the compact host dtypes (uint8 images and masks, float16
    teacher maps) and widens them here."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() / 255.0
    else:
        imgs = imgs.float()
    alt_fn = rgb_to_lab if alt_colorspace == "LAB" else rgb_to_hsv
    # one target set per sigma (reference gt_stddevs_pix list semantics,
    # dataloaders.py:114-118; live configs use a single sigma)
    hw = tuple(imgs.shape[1:3])
    return torch.cat([
        normalize_image(imgs), alt_fn(imgs), masks.float()[..., None],
        segms.float()[..., None],
        *[render_heatmaps(joints, hw, s) for s in sigmas],
        teacher_hms.float(), teacher_ae.float(),
    ], dim=-1)


def _augment_batch_device(imgs, masks, segms, teacher_hms, teacher_ae,
                          joints, matrices, out_hw: Tuple[int, int],
                          sigmas: Tuple[float, ...], num_joints: int,
                          alt_colorspace: str) -> dict:
    """Normalize, colorspace, render, then warp every plane with its
    sample's matrix, on the tensors' device.  Returns NHWC float32
    planes by name (views of one warped stack)."""
    planes = _augment_planes(imgs, masks, segms, teacher_hms, teacher_ae,
                             joints, sigmas, alt_colorspace)
    warped = affine_warp(planes, matrices, out_hw)
    names = ["img", "img_alt", "mask", "segm_mask", "gt_hms"]
    sizes = [3, 3, 1, 1, num_joints]
    for k in range(1, len(sigmas)):
        names.append(f"gt_hms_{k + 1}")
        sizes.append(num_joints)
    names += ["teacher_hms", "teacher_ae"]
    sizes += [teacher_hms.shape[-1], teacher_ae.shape[-1]]
    return dict(zip(names, torch.split(warped, sizes, dim=-1)))


class _CanvasCache:
    """Decode-once memmap cache of fixed-canvas host samples.

    The JPEG decode + RLE rasterize + teacher-npz inflate + resize work
    of the loader is identical every epoch.  This cache materializes
    each sample once in the compact canvas format the pipeline ships
    (image and masks uint8, teacher maps float16) as per-field memmaps,
    so epochs >= 2 are page-cache reads.

    Lazily filled: a row is computed from the dataset the first time it
    is requested and served from the memmap afterwards (concurrent fills
    of distinct rows are thread-safe; a duplicate fill of the same row
    writes identical bytes).  The layout, file names and key are the JAX
    package's (``rtpe_tpu/data/pipeline.py:_CanvasCache``), so a cache
    directory either package filled serves the other.  The key covers
    the dataset's id list, the canvas and joint geometry and the teacher
    corpus; reopening with a different key is an error.

    Disk cost: ~(ch*cw*(5 + 2*(J + ae_dims))) bytes a sample, ~28 MB at
    640x640x17+17.
    """

    def __init__(self, cache_dir: str, dataset, canvas_hw, num_joints,
                 ae_dims):
        from numpy.lib.format import open_memmap

        ch, cw = canvas_hw
        n = len(dataset)
        ids = np.asarray(dataset.ids, np.int64)
        key = hashlib.sha1(
            ids.tobytes()
            + np.asarray([ch, cw, num_joints, ae_dims,
                          MAX_PEOPLE]).tobytes()
            + self._corpus_digest(dataset).encode()
        ).hexdigest()
        meta = {"n": n, "canvas_hw": [ch, cw], "num_joints": num_joints,
                "ae_dims": ae_dims, "max_people": MAX_PEOPLE,
                "key": key}
        os.makedirs(cache_dir, exist_ok=True)
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                found = json.load(f)
            if found != meta:
                raise ValueError(
                    f"canvas cache at {cache_dir} was built for a "
                    f"different dataset/geometry/teacher-corpus "
                    f"({found} != {meta}); use a fresh cache_dir")
        else:
            with open(meta_path, "w") as f:
                json.dump(meta, f)

        def field(name, shape, dtype):
            path = os.path.join(cache_dir, name + ".npy")
            if os.path.exists(path):
                mm = open_memmap(path, mode="r+")
                # a stale or truncated file from an older layout or a
                # crashed fill is a clear key error, not served
                if mm.shape != tuple(shape) or mm.dtype != np.dtype(
                        dtype):
                    raise ValueError(
                        f"canvas cache field {name} at {path} has "
                        f"shape {mm.shape}/{mm.dtype}, expected "
                        f"{tuple(shape)}/{np.dtype(dtype)} — stale or "
                        f"corrupt cache; use a fresh cache_dir")
                return mm
            return open_memmap(path, mode="w+", dtype=dtype,
                               shape=shape)

        self.imgs = field("imgs", (n, ch, cw, 3), np.uint8)
        self.masks = field("masks", (n, ch, cw), np.uint8)
        self.segms = field("segms", (n, ch, cw), np.uint8)
        self.t_hms = field("t_hms", (n, ch, cw, num_joints), np.float16)
        self.t_ae = field("t_ae", (n, ch, cw, ae_dims), np.float16)
        self.joints = field("joints", (n, MAX_PEOPLE, num_joints, 3),
                            np.float32)
        self.hw = field("hw", (n, 2), np.int32)
        self.img_ids = field("img_ids", (n,), np.int64)
        self.filled = field("filled", (n,), np.uint8)
        self.canvas_hw = (ch, cw)
        self.ae_dims = ae_dims

    @staticmethod
    def _corpus_digest(dataset) -> str:
        """Identity of the teacher corpus feeding the cached t_hms/t_ae:
        a digest of each file's name, size and mtime (not its content:
        the reference's corpus is ~400 GB), so a regenerated corpus
        under the same ids and cache_dir is a key error, not stale
        maps."""
        tdir = getattr(dataset, "teacher_dir", None)
        if not tdir:
            return "no-teacher"
        h = hashlib.sha1(os.path.abspath(tdir).encode())
        try:
            names = sorted(os.listdir(tdir))
        except OSError:
            return h.hexdigest()
        for nm in names:
            try:
                st = os.stat(os.path.join(tdir, nm))
            except OSError:
                continue
            h.update(f"{nm}:{st.st_size}:{st.st_mtime_ns}".encode())
        return h.hexdigest()

    def get(self, idx: int, dataset):
        if not self.filled[idx]:
            ch, cw = self.canvas_hw
            s = dataset[idx]
            h, w = s["img"].shape[:2]
            if h > ch or w > cw:
                raise ValueError(
                    f"sample {idx}: image {h}x{w} exceeds the "
                    f"{ch}x{cw} canvas — raise canvas_hw")
            self.imgs[idx, :h, :w] = (s["img"][:h, :w] * 255.0 + 0.5)
            for nm, dst in (("mask", self.masks),
                            ("segm_mask", self.segms)):
                mv = s[nm][:h, :w]
                if not ((mv == 0) | (mv == 1)).all():
                    raise ValueError(
                        f"sample {idx}: non-binary {nm} values cannot "
                        f"be cached as uint8")
                dst[idx, :h, :w] = mv
            if s["teacher_hms"].size:
                self.t_hms[idx, :h, :w] = s["teacher_hms"][:h, :w]
                d = min(self.ae_dims, s["teacher_ae"].shape[-1])
                self.t_ae[idx, :h, :w, :d] = \
                    s["teacher_ae"][:h, :w, :d]
            p = min(MAX_PEOPLE, s["joints"].shape[0])
            self.joints[idx, :p] = s["joints"][:p]
            self.hw[idx] = (h, w)
            self.img_ids[idx] = s["img_id"]
            self.filled[idx] = 1
        return (self.imgs[idx], self.masks[idx], self.segms[idx],
                self.t_hms[idx], self.t_ae[idx], self.joints[idx],
                tuple(int(v) for v in self.hw[idx]),
                int(self.img_ids[idx]))


class _HostSlots:
    """The host buffers of whole batches that the workers fill and the
    consumer uploads from, handed round through a queue: page-locked
    when ``pin`` (CUDA), so the upload is an asynchronous DMA.  A
    worker takes a slot (:meth:`take`), the consumer gives it back once
    its upload has finished (:meth:`give`).  Enough slots for every
    batch in flight plus the two the consumer holds (the one it uploads
    and the one still copying), so no taker waits on a slot that no one
    will give back."""

    def __init__(self, n: int, specs, pin: bool):
        self.free: "queue.Queue" = queue.Queue()
        for _ in range(n):
            self.free.put(tuple(
                torch.from_numpy(np.empty(0, dt)).new_empty(
                    shape, pin_memory=pin) for shape, dt in specs))

    def take(self, stop: threading.Event):
        """A free slot, or None once ``stop`` is set."""
        while not stop.is_set():
            try:
                return self.free.get(timeout=0.5)
            except queue.Empty:
                continue
        return None

    def give(self, slot) -> None:
        self.free.put(slot)


class TrainPipeline:
    """Iterate augmented batches on ``device`` from a
    :class:`~rtpe_tpu_torch.data.dataset.CocoDistillationDataset`: dicts
    of NHWC float32 tensors (``img``, ``img_alt``, ``mask``,
    ``segm_mask``, ``gt_hms``, ``teacher_hms``, ``teacher_ae``), which
    :func:`~rtpe_tpu_torch.train.step.make_distill_train_step` takes,
    and ``img_id``, a host array.

    The arguments and defaults are the JAX pipeline's, plus ``device``
    (``"cuda"`` by default; raises without CUDA unless ``"cpu"``) and
    ``shard``: a slice of each global batch of ``batch_size``
    (:func:`~rtpe_tpu_torch.parallel.dist.process_local_batch_slice`)
    makes this pipeline one process's feed of a data-parallel run.  Its
    rows are the ones the one-process pipeline builds: every process
    shuffles and seeds alike, and draws the augmentation of the rows it
    skips too, with the image size the annotations record (which must
    be the image's)."""

    def __init__(self, dataset, batch_size: int = 16,
                 out_hw: Tuple[int, int] = (450, 450),
                 sigma=7.0,
                 canvas_hw: Tuple[int, int] = (640, 640),
                 augment: Optional[AugmentConfig] = None,
                 alt_colorspace: str = "LAB",
                 teacher_ae_dims: int = 17,
                 seed: int = 0,
                 shuffle: bool = True,
                 prefetch: int = 2,
                 num_workers: int = 1,
                 compact_transfer: bool = True,
                 cache_dir: Optional[str] = None,
                 device: DeviceLike = "cuda",
                 shard: Optional[slice] = None):
        self.ds = dataset
        self.batch_size = batch_size
        rows = shard or slice(0, batch_size)
        self.row0, self.rows = rows.start, rows.stop - rows.start
        self.sharded = self.rows < batch_size
        self.out_hw = tuple(out_hw)
        self.sigmas = tuple(float(s) for s in (
            sigma if isinstance(sigma, (tuple, list)) else (sigma,)))
        self.canvas_hw = tuple(canvas_hw)
        self.augment = augment or AugmentConfig(out_hw=self.out_hw)
        self.alt_colorspace = alt_colorspace
        self.teacher_ae_dims = teacher_ae_dims
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self.num_joints = dataset.num_joints
        self.device = resolve_device(device)
        # compact transfer: images and masks as uint8, teacher maps as
        # float16, ~2x fewer bytes to upload.  The uint8 image round trip
        # is exact (the decoder emits uint8/255 floats); teacher maps
        # quantize to f16 (~5e-4 relative): distillation targets, far
        # below training noise
        self.compact = bool(compact_transfer)
        # decode-once corpus cache: epoch 1 fills per-sample canvases in
        # the compact format, later epochs skip JPEG/RLE/npz/resize.  A
        # non-compact pipeline reading it inherits the f16 teacher maps
        self.cache = (_CanvasCache(cache_dir, dataset, self.canvas_hw,
                                   self.num_joints, teacher_ae_dims)
                      if cache_dir else None)
        self._stream = None

    # ------------------------------------------------------------------
    def _specs(self):
        """(shape, dtype) of each host array of a batch, in order."""
        ch, cw = self.canvas_hw
        b, j = self.rows, self.num_joints
        img_dt = np.uint8 if self.compact else np.float32
        map_dt = np.float16 if self.compact else np.float32
        return [((b, ch, cw, 3), img_dt), ((b, ch, cw), img_dt),
                ((b, ch, cw), img_dt), ((b, ch, cw, j), map_dt),
                ((b, ch, cw, self.teacher_ae_dims), map_dt),
                ((b, MAX_PEOPLE, j, 3), np.float32),
                ((b, 2, 3), np.float32), ((b,), np.int64)]

    def _host_batch(self, indices, rng=None, out=None):
        """One host batch for ``indices``: ``(imgs, masks, segms, t_hms,
        t_ae, joints, mats, img_ids)``, written into ``out`` (numpy
        arrays of :meth:`_specs`, zeroed here) or into new arrays."""
        rng = self.rng if rng is None else rng
        ch, cw = self.canvas_hw
        if out is None:
            out = tuple(np.zeros(shape, dt) for shape, dt in self._specs())
        else:
            for a in out:
                a[...] = 0
        imgs, masks, segms, t_hms, t_ae, joints, mats, img_ids = out

        for kk, idx in enumerate(indices):
            k = kk - self.row0
            if not 0 <= k < self.rows:
                # another process's row: its draws, so that ours follow
                sample_affine_matrices(rng, 1, self._recorded_hw(idx),
                                       self.augment)
                continue
            if self.cache is not None:
                (img_u8, mask_u8, segm_u8, th, ta, jt, (h, w),
                 iid) = self.cache.get(idx, self.ds)
                if self.compact:
                    imgs[k] = img_u8
                    t_hms[k] = th
                    t_ae[k] = ta
                else:
                    imgs[k] = img_u8.astype(np.float32) / 255.0
                    t_hms[k] = th.astype(np.float32)
                    t_ae[k] = ta.astype(np.float32)
                masks[k] = mask_u8
                segms[k] = segm_u8
                joints[k] = jt
                self._check_hw(idx, (h, w))
                mats[k] = sample_affine_matrices(rng, 1, (h, w),
                                                 self.augment)[0]
                img_ids[k] = iid
                continue
            s = self.ds[idx]
            h, w = s["img"].shape[:2]
            if h > ch or w > cw:
                raise ValueError(
                    f"sample {idx}: image {h}x{w} exceeds the "
                    f"{ch}x{cw} canvas — raise canvas_hw (COCO fits 640; "
                    f"silent cropping would corrupt joints/targets)")
            if self.compact:
                # exact inverse of load_image's uint8/255 -> float32
                imgs[k, :h, :w] = (s["img"][:h, :w] * 255.0 + 0.5)
                # uint8 masks are exact only for strictly binary masks
                # (RLE unions are); a soft mask would truncate to 0
                for nm in ("mask", "segm_mask"):
                    mv = s[nm][:h, :w]
                    if not ((mv == 0) | (mv == 1)).all():
                        raise ValueError(
                            f"sample {idx}: non-binary {nm} values in "
                            f"compact mode (min={mv.min()}, "
                            f"max={mv.max()}); use compact_transfer="
                            f"False for soft masks")
            else:
                imgs[k, :h, :w] = s["img"][:h, :w]
            masks[k, :h, :w] = s["mask"][:h, :w]
            segms[k, :h, :w] = s["segm_mask"][:h, :w]
            if s["teacher_hms"].size:
                t_hms[k, :h, :w] = s["teacher_hms"][:h, :w]
                d = min(self.teacher_ae_dims, s["teacher_ae"].shape[-1])
                t_ae[k, :h, :w, :d] = s["teacher_ae"][:h, :w, :d]
            p = min(MAX_PEOPLE, s["joints"].shape[0])
            joints[k, :p] = s["joints"][:p]
            self._check_hw(idx, (h, w))
            mats[k] = sample_affine_matrices(rng, 1, (h, w),
                                             self.augment)[0]
            img_ids[k] = s["img_id"]
        return out

    def _recorded_hw(self, idx: int) -> Tuple[int, int]:
        """Sample ``idx``'s image size as its annotations record it."""
        info = self.ds.coco.img_info(self.ds.ids[idx])
        return int(info["height"]), int(info["width"])

    def _check_hw(self, idx: int, hw) -> None:
        if self.sharded and tuple(hw) != self._recorded_hw(idx):
            raise ValueError(
                f"sample {idx}: image {hw} differs from the annotations' "
                f"{self._recorded_hw(idx)}; a sharded pipeline draws the "
                "augmentation of other processes' rows from that size")

    def _epoch_indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(idx)
        n_full = len(idx) // self.batch_size
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_full)]

    # ------------------------------------------------------------------
    def _host_items(self, slots: Optional[_HostSlots]):
        """Yield ``(arrays, tensors)`` for one epoch: the host batch, and
        the slot's tensors it was written into (None without
        ``slots``)."""
        batches = self._epoch_indices()
        # releases an abandoned producer (the consumer broke out early)
        # instead of leaking a thread blocked on a slot or on q.put
        stop = threading.Event()

        def build(inds, rng=None):
            if slots is None:
                return self._host_batch(inds, rng), None
            tensors = slots.take(stop)
            if tensors is None:
                return None
            try:
                arrays = self._host_batch(
                    inds, rng, tuple(t.numpy() for t in tensors))
            except BaseException:
                slots.give(tensors)
                raise
            return arrays, tensors

        if self.num_workers == 1:
            q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        return True
                    except queue.Full:
                        continue
                return False

            def producer():
                try:
                    for inds in batches:
                        item = build(inds)
                        if item is None or not put(item):
                            return
                    put(None)
                except BaseException as e:  # re-raised on consumer side
                    put(e)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()
        else:
            # per-batch seeds drawn up front: deterministic streams
            # independent of scheduling
            seeds = self.rng.randint(0, 2 ** 31 - 1, size=len(batches))
            inflight = self.num_workers + self.prefetch
            with ThreadPoolExecutor(self.num_workers) as ex:
                try:
                    futs = deque()
                    nxt = 0
                    while nxt < min(inflight, len(batches)):
                        futs.append(ex.submit(
                            build, batches[nxt],
                            np.random.RandomState(seeds[nxt])))
                        nxt += 1
                    while futs:
                        item = futs.popleft().result()
                        if nxt < len(batches):
                            futs.append(ex.submit(
                                build, batches[nxt],
                                np.random.RandomState(seeds[nxt])))
                            nxt += 1
                        yield item
                finally:
                    stop.set()

    def host_batches(self) -> Iterator[tuple]:
        """Yield raw host batches for one epoch (the CPU-side feed):
        ``(imgs, masks, segms, t_hms, t_ae, joints, mats, img_ids)``."""
        for arrays, _ in self._host_items(None):
            yield arrays

    def _upload(self, tensors):
        """The slot's tensors on the device, and the event after which
        the slot may be refilled (None: at once)."""
        dev = self.device
        if dev.type != "cuda":
            return tensors, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        with torch.cuda.stream(self._stream):
            out = tuple(t.to(dev, non_blocking=True) for t in tensors)
            done = torch.cuda.Event()
            done.record(self._stream)
        cur.wait_event(done)
        for t in out:
            t.record_stream(cur)
        return out, done

    def __iter__(self) -> Iterator[dict]:
        slots = _HostSlots(self.num_workers + self.prefetch + 2,
                           self._specs(), pin=self.device.type == "cuda")
        pending = None  # the previous slot, and the end of its upload
        for arrays, tensors in self._host_items(slots):
            dev_tensors, done = self._upload(tensors)
            batch = _augment_batch_device(
                *dev_tensors[:7], self.out_hw, self.sigmas, self.num_joints,
                self.alt_colorspace)
            batch["img_id"] = arrays[7].copy()
            if pending is not None:
                pending[1].synchronize()
                slots.give(pending[0])
                pending = None
            if done is None:
                slots.give(tensors)
            else:
                pending = (tensors, done)
            yield batch

    def __len__(self):
        return len(self.ds) // self.batch_size
