"""Image-directory datasets and the threaded batch loader.

Counterpart of `vspbfr_tpu/data/datasets.py`: `RestoreTestDataset` (the
inference reader) and, for training, the GT side of `RestoreTrainDataset`
(load, flip, resize/crop with per-(seed, epoch, index) numpy streams) and
the threaded prefetching `DataLoader`. The degradation chain itself runs on
the device (`data/device_degrade.py`); the host chain waits.

Files are PNG/JPG or `.npy`: inference reads [-1, 1] float HWC arrays at
the target size, training reads uint8 HWC GT arrays (resized only through
Pillow, when their size differs). Pillow is imported only inside the
functions that need it, so `.npy` data works where it is missing.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator

import numpy as np

from vspbfr_tpu_torch.data.degradations import DegradationConfig

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp")
EXTS = IMG_EXTS + (".npy",)


def list_images(root: str) -> list[str]:
    """Recursive sorted listing of readable files under root."""
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files
                if f.lower().endswith(EXTS)]
    return sorted(out)


def _resize_crop(img: np.ndarray, size: tuple[int, int],
                 rng: np.random.Generator | None) -> np.ndarray:
    """Lanczos aspect-preserving resize + (random | center) crop of a uint8
    HWC image, drawing the crop offsets from rng as the JAX package does
    (`dataset.py:264-280` upstream)."""
    h, w = img.shape[:2]
    th, tw = size
    if h == th and w == tw:
        return img
    from PIL import Image

    ratio = max(th / h, tw / w)
    nw, nh = int(ratio * w), int(ratio * h)
    img = np.asarray(Image.fromarray(img).resize(
        (nw, nh), Image.Resampling.LANCZOS))
    hr, wr = nh - th, nw - tw
    if rng is not None:
        hi = int(rng.integers(0, hr + 1)) if hr > 0 else 0
        wi = int(rng.integers(0, wr + 1)) if wr > 0 else 0
    else:
        hi, wi = hr // 2, wr // 2
    return img[hi:hi + th, wi:wi + tw]


def _load_picture(path: str, size: tuple[int, int]) -> np.ndarray:
    return (_resize_crop(load_u8(path), size, None).astype(np.float32)
            / 127.5 - 1.0)


def load_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a PNG/JPG, or a uint8 HWC `.npy`."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"{path}: {arr.dtype} {arr.shape}, expected "
                             "uint8 (H, W, 3)")
        return arr
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


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


@dataclasses.dataclass
class RestoreTrainDataset:
    """The GT side of the on-the-fly degradation training set.

    quantize_gt=True, gray_prob=None is stage 2 (ImageFolder_restore, whose
    GT round-trips through uint8); the device loader reads quantize_gt,
    gray_prob and config from here. `subset` keeps the first N files (the
    reference's debug subset)."""

    root: str
    im_size: tuple[int, int] = (512, 512)
    quantize_gt: bool = False
    gray_prob: float | None = 0.008
    config: DegradationConfig = dataclasses.field(
        default_factory=DegradationConfig)
    seed: int = 0
    subset: int | None = None

    def __post_init__(self):
        self.files = list_images(self.root)
        if not self.files:
            raise FileNotFoundError(f"no images under {self.root}")
        if self.subset:
            self.files = self.files[: self.subset]

    def __len__(self):
        return len(self.files)

    def sample_gt(self, idx: int, epoch: int = 0
                  ) -> tuple[np.ndarray, np.random.Generator]:
        """(GT uint8 HWC, the rng positioned for the degradation draws):
        the same SeedSequence, flip draw and resize/crop order as the JAX
        package's `sample_gt`."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        img = load_u8(self.files[idx % len(self.files)])
        if rng.integers(0, 2) == 1:
            img = img[:, ::-1]
        img = _resize_crop(img, self.im_size, rng)
        return np.ascontiguousarray(img), rng


class DataLoader:
    """Threaded prefetching batch loader over a dataset with
    `.sample(idx, epoch)`.

    The batch order is deterministic given the seed: each epoch is a
    seeded permutation of the indices, cut into full batches; worker
    threads assemble batches of stacked numpy arrays and hand them out, in
    order, through a bounded queue."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(
                len(self.ds))

    def batches_per_epoch(self) -> int:
        return len(self.ds) // self.batch_size

    def epoch(self, epoch: int = 0,
              start_batch: int = 0) -> Iterator[tuple[np.ndarray, ...]]:
        """One epoch of batches (tuples of stacked arrays). start_batch
        skips the first batches without loading them (the resume cursor)."""
        indices = self._epoch_indices(epoch)
        nb = self.batches_per_epoch()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def batch_of(b):
            rows = [self.ds.sample(int(i), epoch) for i in
                    indices[b * self.batch_size:(b + 1) * self.batch_size]]
            return tuple(np.stack(c) for c in zip(*rows))

        def worker(worker_id):
            for b in range(start_batch + worker_id, nb, self.num_workers):
                if stop.is_set():
                    return
                try:
                    q.put((b, batch_of(b)))
                except Exception as e:  # noqa: BLE001 - re-raised by the reader
                    q.put((b, e))
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: dict[int, tuple] = {}
            nxt = received = start_batch
            while nxt < nb:
                while nxt not in pending and received < nb:
                    b, data = q.get()
                    if isinstance(data, Exception):
                        raise data
                    pending[b] = data
                    received += 1
                yield pending.pop(nxt)
                nxt += 1
        finally:
            stop.set()
            # drain, so producers blocked on a full queue can exit
            while not q.empty():
                q.get_nowait()
            for t in threads:
                t.join(timeout=1.0)

    def forever(self, start_epoch: int = 0,
                start_batch: int = 0) -> Iterator[tuple[np.ndarray, ...]]:
        """Endless stream from the resume cursor (start_epoch,
        start_batch) = divmod(global step, batches_per_epoch())."""
        if self.batches_per_epoch() == 0:
            raise ValueError(f"{len(self.ds)} samples make no full batch of "
                             f"{self.batch_size}")
        e = start_epoch
        yield from self.epoch(e, start_batch)
        while True:
            e += 1
            yield from self.epoch(e)
