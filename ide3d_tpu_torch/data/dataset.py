"""Dataset pipeline: images + 19-channel semantics + 25-dim camera labels.

The port's own copy of ide3d_tpu/data/dataset.py (numpy and PIL only; the port
imports nothing of the JAX package), with the reference's contracts
(training/dataset_seg.py):
  * zip or directory of images, labels in `dataset.json` under key 'labels';
    the stored labels are OpenCV-convention and are sign-flipped on load:
    `labels[:, [1,2,5,6,9,10]] *= -1`,
  * grayscale paletted segmentation masks alongside (`seg_path`), one-hot
    encoded to 19 channels, optional 19->5 class remap,
  * x-flip augmentation relabels the pose: `label[[1,2,3,4,8]] *= -1`,
  * FFHQ rebalance filter keeps fnames with id < 140000.

`infinite_loader` yields the uint8 wire batch (the JAX loader's compact=True:
img [B,H,W,3], seg class ids [B,H,W]); `batch_to_device` moves it to the card
through pinned memory, and the train step expands it there
(train/gan.expand_compact_batch).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Iterator, Optional

import numpy as np

REBALANCE_CUTOFF = 140000
REMAP_19_TO_5 = np.array(
    [0, 1, 1, 4, 2, 2, 2, 2, 1, 1, 2, 2, 2, 3, 4, 4, 4, 1, 4], dtype=np.int64
)


class ImageFolderDataset:
    """Images (+ optional seg masks, + optional camera labels) from dir or zip."""

    def __init__(
        self,
        path: str,
        seg_path: Optional[str] = None,
        resolution: Optional[int] = None,
        use_labels: bool = True,
        load_seg: bool = False,
        remap_5: bool = False,
        rebalance_filter: bool = False,
        xflip: bool = False,
        max_size: Optional[int] = None,
    ):
        import PIL.Image

        self._path = path
        self._seg_path = seg_path
        self.resolution = resolution
        self.load_seg = load_seg
        self.remap_5 = remap_5
        self.num_seg_classes = 5 if remap_5 else 19

        self._zipfile = None
        self._seg_zipfile = None
        if os.path.isdir(path):
            self._type = "dir"
            self._all_fnames = {
                os.path.relpath(os.path.join(root, f), start=path)
                for root, _d, files in os.walk(path)
                for f in files
            }
        elif path.endswith(".zip"):
            self._type = "zip"
            self._all_fnames = set(self._get_zip().namelist())
        else:
            raise IOError("Path must point to a directory or zip")

        PIL.Image.init()
        self._image_fnames = sorted(
            f for f in self._all_fnames if os.path.splitext(f)[1].lower() in PIL.Image.EXTENSION
        )
        if rebalance_filter:
            self._image_fnames = [
                f for f in self._image_fnames if int(f[-12:-4]) < REBALANCE_CUTOFF
            ]
        if not self._image_fnames:
            raise IOError("No image files found")

        self._seg_fnames = None
        if load_seg:
            assert seg_path is not None
            if os.path.isdir(seg_path):
                seg_names = {
                    os.path.relpath(os.path.join(root, f), start=seg_path)
                    for root, _d, files in os.walk(seg_path)
                    for f in files
                }
            else:
                seg_names = set(self._get_seg_zip().namelist())
            self._seg_fnames = sorted(
                f for f in seg_names if os.path.splitext(f)[1].lower() in PIL.Image.EXTENSION
            )
            assert len(self._seg_fnames) >= len(self._image_fnames)

        self._use_labels = use_labels
        self._raw_labels = self._load_raw_labels() if use_labels else None

        n = len(self._image_fnames)
        self._raw_idx = np.arange(n, dtype=np.int64)
        if max_size is not None and n > max_size:
            np.random.RandomState(0).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    # ------------------------------------------------------------------- files

    def _get_zip(self):
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _get_seg_zip(self):
        if self._seg_zipfile is None:
            self._seg_zipfile = zipfile.ZipFile(self._seg_path)
        return self._seg_zipfile

    def _open(self, fname):
        if self._type == "dir":
            return open(os.path.join(self._path, fname), "rb")
        return self._get_zip().open(fname, "r")

    def _open_seg(self, fname):
        if os.path.isdir(self._seg_path):
            return open(os.path.join(self._seg_path, fname), "rb")
        return self._get_seg_zip().open(fname, "r")

    # ------------------------------------------------------------------ labels

    def _load_raw_labels(self):
        if "dataset.json" not in self._all_fnames:
            return None
        with self._open("dataset.json") as f:
            labels = json.load(f).get("labels")
        if labels is None:
            return None
        labels = dict(labels)
        labels = np.array(
            [labels[f.replace("\\", "/")] for f in self._image_fnames], dtype=np.float32
        )
        # OpenCV -> OpenGL sign flip (dataset_seg.py:314)
        labels[:, [1, 2, 5, 6, 9, 10]] *= -1
        return labels

    @property
    def label_dim(self) -> int:
        return 0 if self._raw_labels is None else int(self._raw_labels.shape[1])

    # ------------------------------------------------------------------- items

    def __len__(self):
        return self._raw_idx.size

    def _load_image(self, raw_idx: int) -> np.ndarray:
        import PIL.Image

        with self._open(self._image_fnames[raw_idx]) as f:
            img = PIL.Image.open(f).convert("RGB")
            if self.resolution and img.size != (self.resolution, self.resolution):
                img = img.resize((self.resolution, self.resolution), PIL.Image.LANCZOS)
            return np.array(img, dtype=np.uint8)  # HWC

    def _load_seg_mask(self, raw_idx: int) -> np.ndarray:
        import PIL.Image

        with self._open_seg(self._seg_fnames[raw_idx]) as f:
            img = PIL.Image.open(f).convert("L")
            if self.resolution and img.size != (self.resolution, self.resolution):
                img = img.resize((self.resolution, self.resolution), PIL.Image.NEAREST)
            mask = np.array(img, dtype=np.int64)
        if self.remap_5:
            mask = REMAP_19_TO_5[mask]
        return mask  # HW int

    def get_label(self, idx: int) -> np.ndarray:
        """The label of item idx, relabeled for a mirrored copy, without reading
        its image (the reference dataset's get_label)."""
        raw = int(self._raw_idx[idx])
        if self._raw_labels is None:
            return np.zeros(0, np.float32)
        label = self._raw_labels[raw].copy()
        if self._xflip[idx] and label.size == 25:
            label[[1, 2, 3, 4, 8]] *= -1
        return label

    def __getitem__(self, idx: int):
        """(image uint8 HWC, [seg one-hot HWC float32 when load_seg], label),
        x-flipped and relabeled for the mirrored copies (the metrics' reader)."""
        raw = int(self._raw_idx[idx])
        img = self._load_image(raw)
        seg = None
        if self.load_seg:
            mask = self._load_seg_mask(raw)
            seg = np.zeros((mask.shape[0], mask.shape[1], self.num_seg_classes), np.float32)
            np.put_along_axis(seg, mask[..., None], 1.0, axis=-1)
        if self._xflip[idx]:
            img = img[:, ::-1].copy()
            if seg is not None:
                seg = seg[:, ::-1].copy()
        if seg is not None:
            return img, seg, self.get_label(idx)
        return img, self.get_label(idx)

    def raw_item(self, idx: int):
        """Raw uint8 image + integer mask + label + xflip flag, for the compact
        loader (which flips the pixels; the label is relabeled here)."""
        raw = int(self._raw_idx[idx])
        img = self._load_image(raw)
        label = (
            self._raw_labels[raw].copy()
            if self._raw_labels is not None
            else np.zeros(0, np.float32)
        )
        flip = bool(self._xflip[idx])
        if flip and label.size == 25:
            label[[1, 2, 3, 4, 8]] *= -1
        mask = self._load_seg_mask(raw).astype(np.uint8) if self.load_seg else None
        return img, mask, label, flip


class CameraLabeledDataset(ImageFolderDataset):
    """(image uint8 HWC, seg one-hot HWC float32, 25-dim camera label) triples
    (contract: dataset_seg.py:373-396)."""

    def __init__(self, path, seg_path, **kw):
        kw.setdefault("load_seg", True)
        super().__init__(path, seg_path=seg_path, **kw)


def infinite_loader(dataset, batch_size: int, seed: int = 0, rank: int = 0,
                    world_size: int = 1) -> Iterator[dict]:
    """Infinite batch iterator over a seeded epoch permutation, repeated
    forever. Yields the compact wire batch: img uint8 [B,H,W,3], seg uint8
    class ids [B,H,W] (with seg masks), c float32 [B,25]; about 1/22 of the
    one-hot fp32 batch's bytes at 512², expanded on the card
    (train.gan.expand_compact_batch).

    `batch_size` is the global batch; rank `rank` of `world_size` gets its
    rows [rank*b, (rank+1)*b), b = batch_size / world_size, of each global
    batch of the same permutation (and reads only those items), so W ranks
    together see what one process sees."""
    if batch_size % world_size:
        raise ValueError(f"batch {batch_size} not divisible by the world size {world_size}")
    b = batch_size // world_size
    n = len(dataset)
    rng = np.random.RandomState(seed)
    order = np.arange(n)
    pos = 0
    while True:
        imgs, segs, labels = [], [], []
        for i in range(batch_size):
            if pos == 0:
                rng.shuffle(order)
            idx = int(order[pos])
            pos = (pos + 1) % n
            if i // b != rank:
                continue
            img, mask, label, flip = dataset.raw_item(idx)
            if flip:
                img = img[:, ::-1]
                if mask is not None:
                    mask = mask[:, ::-1]
            imgs.append(np.ascontiguousarray(img))
            if mask is not None:
                segs.append(np.ascontiguousarray(mask.astype(np.uint8)))
            labels.append(label)
        batch = {"img": np.stack(imgs), "c": np.stack(labels).astype(np.float32)}
        if segs:
            batch["seg"] = np.stack(segs)
        yield batch


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on `device`; to a card through pinned host memory
    without blocking the host."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out
