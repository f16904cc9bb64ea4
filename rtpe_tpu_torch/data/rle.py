"""COCO run-length-encoded masks, pure numpy (+cv2 for polygon fill).

Port of ``rtpe_tpu/data/rle.py``.  The reference gets RLE decode and
polygon rasterization from pycocotools' C extension
(``rtpe/dataloaders.py:167-201``), which is not installed, so the COCO
mask formats are implemented here:

* compressed RLE: the COCO ascii varint scheme (5 bits a char, offset
  48, sign extension on the 0x10 bit, delta-coded from the 3rd count on)
* uncompressed RLE: ``{"counts": [ints], "size": [h, w]}``
* polygons: rasterized with ``cv2.fillPoly`` (``cv2`` is imported where
  it is used, so that importing this module does not need it)

Masks are column-major (Fortran) order like COCO's.

Compressed counts are decoded by the host C++ codec
(:mod:`rtpe_tpu_torch.native`, ``rle.cpp``) as in the JAX package, and
by the Python decode below where that library is unavailable.
:func:`rle_encode` stays in numpy, as JAX's does.
"""

from typing import Dict, List, Sequence, Union

import numpy as np

from ..native import native_rle_decode


def decode_rle_counts(s: Union[str, bytes]) -> List[int]:
    """Decode the COCO compressed-RLE ascii counts string."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_rle_counts(counts: Sequence[int]) -> str:
    """Inverse of :func:`decode_rle_counts`."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x = int(x) - int(counts[i - 2])
        else:
            x = int(x)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)
                        or x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_decode(rle: Dict) -> np.ndarray:
    """RLE dict -> (h, w) uint8 mask.  Accepts compressed or raw counts;
    compressed ones go through the C++ codec where it is built."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        raw = counts.encode("ascii") if isinstance(counts, str) else counts
        native = native_rle_decode(raw, h, w)
        if native is not None:
            return native
        counts = decode_rle_counts(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict:
    """(h, w) binary mask -> RLE dict (compressed counts by default)."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)  # column-major
    # run lengths, starting with a (possibly zero-length) run of 0s
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w],
            "counts": encode_rle_counts(counts) if compress else counts}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """List of flat [x0, y0, x1, y1, ...] polygons -> (h, w) uint8 mask."""
    import cv2
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [np.asarray(p, dtype=np.float64).reshape(-1, 2)
           for p in polys if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, [np.round(p).astype(np.int32) for p in pts], 1)
    return mask


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation field (polygons / RLE / raw RLE) -> mask."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    if isinstance(segm, dict):
        return rle_decode(segm)
    raise TypeError(f"unknown segmentation type {type(segm)}")


def mask_area(mask: np.ndarray) -> int:
    return int(np.asarray(mask, dtype=bool).sum())
