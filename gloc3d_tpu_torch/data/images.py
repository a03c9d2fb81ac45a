"""Preprocessed-BEV-image loading for the i2i path: the port's copy of the
JAX package's ``data/images.py``.

The reference's primary workflow trains VGG16+NetVLAD-FC on pre-rendered
768×768 probability JPEGs (i2i_util.py:156, kitti_i2i prob_img dirs); the
preprocessing CLI writes .npz images (``image`` uint8, ``origin_xy``,
optionally ``resolution``). This module loads either into model-ready
arrays: centre pad / crop to the configured size with 255 fill
(i2i_util.py:53-91), 1/255 scaling to the float images the network eats
(ToScaledTensor, i2i_util.py:26-31), replicated to 3 channels like the
reference's BGR JPEGs.

JPEG / PNG decoding needs PIL, imported only for such a file; without PIL
that file raises ``ImportError`` (there is no other decoder). The .npz path
needs numpy alone.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from gloc3d_tpu_torch.data.dataset import TripletDataset

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def pad_and_crop(img: np.ndarray, size: int, fill: int = 255) -> np.ndarray:
    """Centre pad / crop a (H, W) uint8 image to (size, size), 255 fill
    (i2i_util.py:53-69 semantics)."""
    h, w = img.shape[:2]
    out = np.full((size, size), fill, img.dtype)
    ch, cw = min(h, size), min(w, size)
    it, il = (h - ch) // 2, (w - cw) // 2
    ot, ol = (size - ch) // 2, (size - cw) // 2
    out[ot:ot + ch, ol:ol + cw] = img[it:it + ch, il:il + cw]
    return out


def _decode(path: str) -> np.ndarray:
    """A JPEG / PNG probability image as (H, W) uint8 greyscale."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding JPEG / PNG BEV images needs PIL (Pillow), "
            "which is not installed; convert them to .npz (image uint8, "
            "origin_xy) or install Pillow") from e
    return np.asarray(Image.open(path).convert("L"))


def load_bev_images(paths: Sequence[str], size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Image files → ((N, size, size, 3) float32 in [0, 1], (N, 2) origins).

    Origins follow the centre pad / crop: output pixel (0, 0) is input
    pixel (it − ot, il − ol), so the metric origin shifts by that pixel
    offset × resolution (rows = y, cols = x). A JPEG / PNG (the reference's
    save_probability_img artefacts) is submap-centred at 0.2 m
    (submap_3d.cpp:265-276), so its origin is minus half its extent."""
    imgs = np.empty((len(paths), size, size, 3), np.float32)
    origins = np.zeros((len(paths), 2), np.float32)
    for i, p in enumerate(paths):
        if p.lower().endswith(_IMAGE_EXTS):
            src, res, d = _decode(p), 0.2, None
        else:
            d = np.load(p)
            src = d["image"]
            res = float(d["resolution"]) if "resolution" in d else 0.2
        img = pad_and_crop(src, size)
        imgs[i] = (img.astype(np.float32) / 255.0)[..., None].repeat(3, -1)
        h, w = src.shape[:2]
        it, il = (h - min(h, size)) // 2, (w - min(w, size)) // 2
        ot, ol = (size - min(h, size)) // 2, (size - min(w, size)) // 2
        base = (np.asarray(d["origin_xy"], np.float32) if d is not None
                else np.float32([-(w // 2) * res, -(h // 2) * res]))
        origins[i] = base + np.asarray(
            [(il - ol) * res, (it - ot) * res], np.float32)
    return imgs, origins


def image_paths_for_scans(scan_files: Sequence[str], img_dir: str,
                          ext: str = ".npz") -> List[str]:
    """Scan file names → their preprocessed image files (the velodyne →
    prob_img rewrite, kitti_i2i.py:170-173). Where the ``ext`` file is
    absent, the reference's JPEG / PNG prob_img files are tried in turn."""
    out = []
    for f in scan_files:
        stem = os.path.splitext(os.path.basename(f))[0]
        p = os.path.join(img_dir, stem + ext)
        if not os.path.exists(p):
            for alt in _IMAGE_EXTS:
                q = os.path.join(img_dir, stem + alt)
                if os.path.exists(q):
                    p = q
                    break
        out.append(p)
    return out


def load_split_images(split, img_dir: str, size: int = 768
                      ) -> TripletDataset:
    """A split (``db_files``, ``q_files``, ``utm_db``, ``utm_q``,
    ``db_poses``, ``q_poses``) and its preprocessed image dir → an i2i
    TripletDataset."""
    db_imgs, db_origins = load_bev_images(
        image_paths_for_scans(split.db_files, img_dir), size)
    q_imgs, q_origins = load_bev_images(
        image_paths_for_scans(split.q_files, img_dir), size)
    return TripletDataset(
        db_inputs=db_imgs, q_inputs=q_imgs,
        utm_db=split.utm_db, utm_q=split.utm_q,
        db_poses=split.db_poses, q_poses=split.q_poses,
        db_origins=db_origins, q_origins=q_origins)
