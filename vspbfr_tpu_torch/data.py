"""Image-directory reader and writer for inference.

Counterpart of `vspbfr_tpu/data/datasets.py::RestoreTestDataset` (the
training datasets and degradations wait). Reads PNG/JPG (Lanczos resize +
center crop, as the JAX package) and `.npy` HWC float arrays already in
[-1, 1] at the target size. Pillow is imported only inside the PNG/JPG
functions, so `.npy` input and output work where it is missing.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp")
EXTS = IMG_EXTS + (".npy",)


def list_images(root: str) -> list[str]:
    """Recursive sorted listing of readable files under root."""
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files
                if f.lower().endswith(EXTS)]
    return sorted(out)


def _load_picture(path: str, size: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    th, tw = size
    if h != th or w != tw:
        ratio = max(th / h, tw / w)
        nw, nh = int(ratio * w), int(ratio * h)
        img = img.resize((nw, nh), Image.Resampling.LANCZOS)
        hi, wi = (nh - th) // 2, (nw - tw) // 2
        img = img.crop((wi, hi, wi + tw, hi + th))
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def load_image(path: str, size: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1]."""
    if path.lower().endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.shape != (*size, 3):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{(*size, 3)}")
        return arr
    return _load_picture(path, size)


def save_image(path_stem: str, img: np.ndarray) -> str:
    """Write an (H, W, 3) [-1, 1] image as PNG when Pillow imports, else as
    `.npy`; returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path_stem + ".npy", np.asarray(img, np.float32))
        return path_stem + ".npy"
    arr = np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path_stem + ".png")
    return path_stem + ".png"


@dataclasses.dataclass
class RestoreTestDataset:
    """Paired (or lq-only) eval set of [-1, 1] HWC images."""

    lq_root: str
    hq_root: str | None = None
    im_size: tuple[int, int] = (512, 512)

    def __post_init__(self):
        self.lq_files = list_images(self.lq_root)
        if not self.lq_files:
            raise FileNotFoundError(f"no images under {self.lq_root}")
        self.hq_files = list_images(self.hq_root) if self.hq_root else None
        if self.hq_files is not None and len(self.hq_files) != len(
                self.lq_files):
            raise ValueError("lq/hq count mismatch")

    def __len__(self):
        return len(self.lq_files)

    def sample(self, idx: int):
        lq = load_image(self.lq_files[idx], self.im_size)
        name = os.path.splitext(os.path.basename(self.lq_files[idx]))[0]
        if self.hq_files is None:
            return lq, None, name
        return lq, load_image(self.hq_files[idx], self.im_size), name

    def batches(self, batch_size: int):
        """In-order batches (low, gt or None, names)."""
        for start in range(0, len(self), batch_size):
            items = [self.sample(i) for i in
                     range(start, min(start + batch_size, len(self)))]
            low = np.stack([it[0] for it in items])
            gt = (None if self.hq_files is None
                  else np.stack([it[1] for it in items]))
            yield low, gt, [it[2] for it in items]
