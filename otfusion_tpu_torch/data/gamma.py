"""Legacy GAMMA (fundus + OCT) dataset (port of
``otfusion_tpu.data.gamma``; reference data_gamma.py:193-378).

On-disk layout (reference __getitem__, data_gamma.py:253-267):

    <root>/MGamma/<index>/data_<index>.nii                (OCT volume)
    <root>/multi-modality_images/<index>/data_<index>_fundus.png
    label CSV: columns [data, <one-hot class columns...>]

Loading: the fundus PNG decoded to RGB and resized to 384x384 with PIL's
bilinear filter (``data.png_io``, no PIL), the OCT volume resized to 96^3,
both scaled by /255; label = argmax of the one-hot row. Train augmentations
draw from one ``random.Random(seed)`` in the JAX loader's order, so batch
order and augmentations are bit-identical to it: colour jitter (p=0.8),
random grayscale (p=0.2), horizontal flip for fundus; horizontal flip (on
W) for OCT. Batches keep the JAX layouts, fundus (B, H, W, 3) and OCT
(B, D, H, W, 1), as CPU tensors of the feed dtype
(``data.loader.feed_dtype_for``); labels int64.
"""

from __future__ import annotations

import csv
import os
import random
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from otfusion_tpu_torch.data.nifti_io import read_nifti, write_nifti
from otfusion_tpu_torch.data.png_io import (
    read_png,
    resize_bilinear_uint8,
    write_png,
)
from otfusion_tpu_torch.data.preprocess import resize_trilinear_np


def read_gamma_labels(label_file: str | Path) -> dict[int, int]:
    """CSV of [data, onehot...] -> {index: argmax label}."""
    out = {}
    with open(label_file) as f:
        reader = csv.reader(f)
        next(reader)  # the header row
        for row in reader:
            if not row:
                continue
            onehot = [float(v) for v in row[1:]]
            out[int(row[0])] = int(np.argmax(onehot))
    return out


def list_gamma_cases(dataset_root: str | Path) -> List[str]:
    """Numeric case directories under the MGamma root, sorted."""
    root = Path(dataset_root)
    return sorted(
        [d.name for d in root.iterdir() if d.is_dir() and d.name.isdigit()]
    )


def load_fundus(path: str | Path, size: int = 384) -> np.ndarray:
    img = resize_bilinear_uint8(read_png(path), size)
    return np.asarray(img, np.float32) / 255.0


def load_oct(path: str | Path, shape=(96, 96, 96)) -> np.ndarray:
    vol = np.nan_to_num(np.asarray(read_nifti(path), np.float32))
    if vol.ndim == 4:
        vol = vol[..., 0]
    vol = resize_trilinear_np(vol, tuple(shape))
    return (vol / 255.0)[..., None]


def _color_jitter(img: np.ndarray, rng: random.Random) -> np.ndarray:
    """Brightness/contrast/saturation 0.2, hue 0.1 — behavioural stand-in
    for torchvision ColorJitter."""
    b = 1.0 + rng.uniform(-0.2, 0.2)
    c = 1.0 + rng.uniform(-0.2, 0.2)
    s = 1.0 + rng.uniform(-0.2, 0.2)
    img = img * b
    mean = img.mean()
    img = (img - mean) * c + mean
    gray = img.mean(axis=2, keepdims=True)
    img = gray + (img - gray) * s
    return np.clip(img, 0.0, 1.0)


class GammaDataset:
    """Index of (case_id, label) pairs with lazy loading."""

    def __init__(
        self,
        dataset_root: str | Path,
        label_file: str | Path,
        filelists: Sequence[str] | None = None,
        oct_shape=(96, 96, 96),
        fundus_size: int = 384,
    ):
        self.root = Path(dataset_root)
        self.images_root = Path(
            str(self.root).replace("/MGamma", "/multi-modality_images")
        )
        self.oct_shape = tuple(oct_shape)
        self.fundus_size = fundus_size
        labels = read_gamma_labels(label_file)
        cases = (
            [os.path.basename(f) for f in filelists]
            if filelists is not None
            else list_gamma_cases(self.root)
        )
        self.samples: List[Tuple[str, int]] = [
            (c, labels[int(c)]) for c in cases if c.isdigit()
            and int(c) in labels
        ]
        if not self.samples:
            raise RuntimeError(f"No GAMMA cases found under {self.root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, case: str) -> Tuple[np.ndarray, np.ndarray]:
        fundus = load_fundus(
            self.images_root / case / f"data_{case}_fundus.png",
            self.fundus_size,
        )
        oct_vol = load_oct(
            self.root / case / f"data_{case}.nii", self.oct_shape
        )
        return fundus, oct_vol


class GammaLoader:
    """Batching loader with the reference's train-time augmentations."""

    def __init__(
        self,
        dataset: GammaDataset,
        indices: Sequence[int],
        batch_size: int,
        shuffle: bool = False,
        augment: bool = False,
        seed: int = 42,
        feed_dtype: torch.dtype = torch.float32,
    ):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.rng = random.Random(seed)
        # bf16 compute mode ships bf16 batches: the first conv casts
        # anyway (see data/loader.py:feed_dtype_for)
        self.feed_dtype = feed_dtype
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def _get(self, case: str):
        if case not in self._cache:
            self._cache[case] = self.dataset.load(case)
        return self._cache[case]

    def _augment(self, fundus, oct_vol):
        if self.rng.random() < 0.8:
            fundus = _color_jitter(fundus, self.rng)
        if self.rng.random() < 0.2:
            fundus = np.repeat(fundus.mean(axis=2, keepdims=True), 3, axis=2)
        if self.rng.random() < 0.5:
            fundus = fundus[:, ::-1, :]
        if self.rng.random() < 0.5:
            oct_vol = oct_vol[:, :, ::-1, :]
        return np.ascontiguousarray(fundus), np.ascontiguousarray(oct_vol)

    def __iter__(
        self,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        order = list(self.indices)
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            fundus, octs, labels = [], [], []
            for i in chunk:
                case, label = self.dataset.samples[i]
                f, o = self._get(case)
                if self.augment:
                    f, o = self._augment(f, o)
                fundus.append(f)
                octs.append(o)
                labels.append(label)
            yield (
                torch.from_numpy(np.stack(fundus)).to(self.feed_dtype),
                torch.from_numpy(np.stack(octs)).to(self.feed_dtype),
                torch.tensor(labels, dtype=torch.int64),
            )


def make_synthetic_gamma(
    root: str | Path,
    n_cases: int = 8,
    n_classes: int = 2,
    fundus_size: int = 64,
    oct_shape=(24, 24, 24),
    seed: int = 0,
) -> tuple[Path, Path]:
    """Miniature GAMMA-layout fixture; returns (mgamma_root, label_csv).
    The same files as the JAX package's from the same seed."""
    root = Path(root)
    mgamma = root / "MGamma"
    images = root / "multi-modality_images"
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_cases):
        case = f"{i:04d}"
        label = i % n_classes
        (mgamma / case).mkdir(parents=True, exist_ok=True)
        (images / case).mkdir(parents=True, exist_ok=True)
        base = rng.uniform(0, 80, size=(fundus_size, fundus_size, 3))
        base[:, :, label] += 120.0  # class-tinted channel
        write_png(images / case / f"data_{case}_fundus.png",
                  base.astype(np.uint8))
        vol = rng.uniform(0, 100, size=oct_shape).astype(np.float32)
        vol += label * 80.0
        write_nifti(mgamma / case / f"data_{case}.nii", vol)
        onehot = [0] * n_classes
        onehot[label] = 1
        rows.append([case, *onehot])
    label_csv = root / "labels.csv"
    with open(label_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["data"] + [f"c{i}" for i in range(n_classes)])
        writer.writerows(rows)
    return mgamma, label_csv


def _salt_pepper_hwc(image: np.ndarray, amount: float,
                     rng: np.random.RandomState) -> np.ndarray:
    """Reference ``add_salt_peper`` (data_gamma.py:36-50): scatter
    ``amount * H * W`` salt(=1)/pepper(=0) pixels across ALL channels of
    an (H, W, C) image; coordinates drawn per-axis with randint(0, dim-1)
    (so the last row/column is never hit — reference quirk kept)."""
    out = np.copy(image)
    n_salt = int(np.ceil(amount * image.shape[0] * image.shape[1] * 0.5))
    coords = [rng.randint(0, i - 1, n_salt) for i in image.shape]
    out[coords[0], coords[1], :] = 1.0
    n_pepper = int(np.ceil(amount * image.shape[0] * image.shape[1] * 0.5))
    coords = [rng.randint(0, i - 1, n_pepper) for i in image.shape]
    out[coords[0], coords[1], :] = 0.0
    return out


def _resize_hwc_cubic(image: np.ndarray, size: int) -> np.ndarray:
    """Bicubic (H, W, C) resize — stands in for the reference's
    ``cv2.resize(..., INTER_CUBIC)`` (``scale_image``, data_gamma.py:54-56;
    cv2 is not a dependency). scipy's cubic spline zoom differs from
    cv2's Catmull-Rom at boundary pixels only."""
    from scipy import ndimage

    h, w = image.shape[:2]
    zoom = (size / h, size / w) + (1,) * (image.ndim - 2)
    return ndimage.zoom(image, zoom, order=3, grid_mode=True,
                        mode="grid-constant").astype(image.dtype)


def resize_oct_nearest(data: np.ndarray, shape=(96, 96, 96)) -> np.ndarray:
    """Reference ``resize_oct_data_trans`` (data_gamma.py:59-69): squeeze
    to 3-D then nearest-neighbour (order-0) ``ndimage.zoom`` to ``shape``
    — numerically identical to upstream (same scipy call)."""
    from scipy import ndimage

    data = np.squeeze(data)
    scale = [t / s for t, s in zip(shape, data.shape)]
    return ndimage.zoom(data, scale, order=0)


class MultiModalFileListDataset:
    """The reference's second GAMMA-era loader, ``Multi_modal_data``
    (data_gamma.py:72-192): modality file-lists + a ground-truth list
    under ``<root>/<folder>/`` drive per-sample ``.npy`` loads.

    Upstream this class is dead code (main.py:30 and test.py:19 import
    only ``GAMMA_dataset``); it is kept for completeness. Layout:

        <root>/<folder>/{mode}_{modality}.txt   (one .npy path per line)
        <root>/<folder>/{mode}_GT.txt           (one integer label per line)

    Behavioural parity notes:
      * "FUN" (fundus) modalities ship (C, H, W); ``model_base=
        'transformer'`` resizes to 384x384 bicubic (HWC round-trip) before
        the /255 scaling, exactly like upstream's scale_image path.
      * other modalities (OCT volumes): ``transformer`` resizes to 96^3
        with order-0 zoom, then /255 and a leading channel axis.
      * noise conditions (``condition='noise'``): ``SaltPepper`` scatters
        fixed-count salt/pepper pixels; the ``Gaussian`` branch reproduces
        the UPSTREAM BUG verbatim (data_gamma.py:146-149: the image is
        replaced by ``clip(zeros, 0, 1)`` — all-zero output; the drawn
        noise is discarded); any other name applies additive
        N(0, g_variance) + clip + salt-pepper, upstream's default arm.
      * upstream reseeds the GLOBAL NumPy RNG per item
        (``np.random.seed(seed_idx)``, data_gamma.py:117) so every item
        sees the same noise draw; reproduced with a per-item
        ``RandomState(seed_idx)`` so the process-global RNG is untouched.
      * upstream's MMOCTF branch rewrites a hardcoded Windows prefix
        (data_gamma.py:121-122); generalised to ``path_map=(old, new)``.
    """

    def __init__(self, root, modal_number, modalties, mode,
                 condition="normal", folder="folder0", *,
                 condition_name="", seed_idx=0, sp_variance=0.05,
                 g_variance=0.05, model_base="cnn", path_map=None):
        self.root = str(root)
        self.mode = mode
        self.data_path = os.path.join(self.root, folder)
        self.modalties = list(modalties)
        self.condition = condition
        self.condition_name = condition_name
        self.seed_idx = seed_idx
        self.sp_variance = sp_variance
        self.g_variance = g_variance
        self.model_base = model_base
        self.path_map = tuple(path_map) if path_map else None

        self.X: dict[int, list[str]] = {}
        for m_num in range(modal_number):
            name = os.path.join(self.data_path,
                                f"{mode}_{self.modalties[m_num]}.txt")
            # the reference opens with encoding="gb18030" (file lists
            # were authored on a zh-CN box); errors="ignore" matches
            with open(name, encoding="gb18030", errors="ignore") as fx:
                self.X[m_num] = [ln.strip() for ln in fx if ln.strip()]
        with open(os.path.join(self.data_path, f"{mode}_GT.txt")) as fy:
            self.y = [ln.strip() for ln in fy if ln.strip()]

    def __len__(self) -> int:
        return len(self.X[0])

    def __getitem__(self, file_num: int):
        rng = np.random.RandomState(self.seed_idx)
        data: dict[int, np.ndarray] = {}
        for m_num in range(len(self.X)):
            path = self.X[m_num][file_num]
            if self.path_map:
                path = path.replace(*self.path_map)
            arr = np.load(path).astype(np.float32)
            if self.modalties[m_num] == "FUN":
                if self.model_base == "transformer":
                    arr = _resize_hwc_cubic(arr.transpose(1, 2, 0), 384)
                    arr = arr.transpose(2, 0, 1) / 255.0
                else:
                    arr = arr / 255.0
                noisy = arr.copy()
                if self.condition == "noise":
                    if self.condition_name == "SaltPepper":
                        noisy = _salt_pepper_hwc(
                            noisy.transpose(1, 2, 0), self.sp_variance,
                            rng).transpose(2, 0, 1)
                    elif self.condition_name == "Gaussian":
                        # upstream bug kept: the drawn noise is discarded
                        # and the output replaced by clip(zeros, 0, 1)
                        rng.normal(0, 0.8, noisy.shape)
                        noisy = np.clip(np.zeros_like(noisy), 0.0, 1.0)
                    else:
                        noisy = np.clip(
                            noisy + rng.normal(0, self.g_variance,
                                               noisy.shape), 0.0, 1.0)
                        # upstream quirk kept: this arm salt-peppers the
                        # (C, H, W) array WITHOUT the HWC transpose
                        # (data_gamma.py:152-157), so counts scale with
                        # C*H and the scatter runs along W
                        noisy = _salt_pepper_hwc(noisy, self.sp_variance,
                                                 rng)
                data[m_num] = noisy.astype(np.float32)
            else:
                if self.model_base == "transformer":
                    arr = resize_oct_nearest(arr, (96, 96, 96))
                arr = arr / 255.0
                data[m_num] = np.expand_dims(arr.astype(np.float32), 0)
        return data, int(self.y[file_num])
