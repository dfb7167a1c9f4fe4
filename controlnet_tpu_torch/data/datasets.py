"""Training data: the reference's file trees, ``.npy`` arrays, and seeded
batching.

The readers are the port's own copies of ``controlnet_tpu/data/datasets.py``'s
(``tests/test_torch_port_data.py`` holds them equal to the JAX readers, item
for item, on trees the JAX generator writes):

* ``MnistDataset``: a grayscale class-dir PNG tree (``<im_path>/<class>/*.png``)
  -> (H, W, 1) float32 in [-1, 1], with ``return_hints`` a (H, W, 3) {0, 1}
  ``cv2.Canny(im, 100, 200)`` hint;
* ``CifarDataset``: the same, RGB, the hint taken on the gray conversion;
* ``CelebDataset``: a flat image directory, resize + center-crop to
  ``im_size``; its latent-cache mode (keys are image basenames, full-path keys
  of foreign caches accepted; an incomplete cache reports ``use_latents =
  False``); ``return_hint`` takes canny on the raw RGB image at
  ``canny_im_size``.

Items are NHWC numpy arrays, as in the JAX package; the tools move each batch
to the device as NCHW.  cv2 and PIL are imported where they are used, so the
package imports without them; a hint asked of a reader without cv2 raises.

``iterate_batches`` keeps the JAX contract over a reader or an array: a
seeded permutation (``np.random.default_rng(seed).permutation``), the
trailing partial batch dropped, a dataset smaller than one batch yields one
short batch; over a reader, ``prefetch`` batches are decoded ahead on a
thread that stops when the consumer does.

The ``.npy`` route: ``load_images`` reads one (N, H, W, C) array (uint8 in
[0, 255] or float in [0, 1]; (N, H, W) is taken as one channel) and maps it to
[-1, 1] as the readers do; ``load_split`` reads a split with its optional
hints.  ``ImageSource`` is what the tools iterate: either such arrays held on
the device, or a reader.

The latent cache: ``load_latents`` merges the ``*.pkl`` shards of the
reference (pickled dicts of torch tensors) and the ``*.npz`` shards that
``tools/infer_vae.py`` writes, each a {key: encoder moments} dict, and
``latents_from_batch`` draws latents from cached moments mean || logvar.
"""

from __future__ import annotations

import glob
import os
import pickle
import queue
import threading

import numpy as np
import torch


def to_unit(images: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] -> float32 [-1, 1]."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    return images.astype(np.float32) * 2.0 - 1.0


def load_images(path: str) -> np.ndarray:
    """An ``.npy`` of (N, H, W[, C]) images -> float32 (N, H, W, C) in [-1, 1]."""
    images = np.load(path)
    if images.ndim == 3:
        images = images[..., None]
    if images.ndim != 4:
        raise ValueError(f"{path}: expected (N, H, W[, C]) images, got shape {images.shape}")
    return to_unit(images)


def batch_indices(n: int, batch_size: int, shuffle: bool = False, seed: int = 0):
    """Index arrays of the batches of one epoch over ``n`` samples."""
    if n == 0:
        return
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    num_batches = n // batch_size
    if num_batches == 0:
        yield order
        return
    for i in range(num_batches):
        yield order[i * batch_size:(i + 1) * batch_size]


def _collate(items: list):
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[j] for it in items]) for j in range(len(items[0])))
    return np.stack(items)


def iterate_batches(data, batch_size: int, shuffle: bool = False, seed: int = 0,
                    prefetch: int = 2, rows=None):
    """Batches of ``data`` in the order of ``batch_indices``.  ``data`` is a
    numpy array, a tensor (indexed on its own device), or a reader (items
    collated into numpy batches; a tuple item into a tuple of batches).  Over
    a reader, ``prefetch > 0`` decodes up to that many batches ahead on a
    daemon thread, which stops when the generator is closed or dropped.
    ``rows`` maps each batch's index array to the indices to take (a
    data-parallel rank's rows, ``cli.put_batch``), before anything is read."""
    chunks = batch_indices(len(data), batch_size, shuffle, seed)
    if rows is not None:
        chunks = (rows(idx) for idx in chunks)
    if isinstance(data, (np.ndarray, torch.Tensor)):
        for idx in chunks:
            if isinstance(data, torch.Tensor):
                yield data[torch.from_numpy(idx).to(data.device)]
            else:
                yield data[idx]
        return
    if prefetch <= 0:
        for idx in chunks:
            yield _collate([data[int(i)] for i in idx])
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    end = object()

    def put(item) -> None:
        # a plain blocking put would keep this thread (and up to ``prefetch``
        # batches) alive forever once the consumer stops reading
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce() -> None:
        try:
            for idx in chunks:
                if stop.is_set():
                    return
                put(_collate([data[int(i)] for i in idx]))
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def load_hints(path: str) -> np.ndarray:
    """An ``.npy`` of (N, H, W, C) hints with values in [0, 1] (edge maps,
    any dtype) -> float32."""
    hints = np.asarray(np.load(path), np.float32)
    if hints.ndim != 4:
        raise ValueError(f"{path}: expected (N, H, W, C) hints, got shape {hints.shape}")
    return hints


def load_split(images_path: str, hints_path: str | None, device) -> tuple:
    """One split (train or test) on ``device``: (images float32 NCHW in
    [-1, 1], hints float32 NCHW in [0, 1] or None).  The test split of the
    distillation tools is a second such pair of ``.npy`` files."""
    images = torch.from_numpy(load_images(images_path)).permute(0, 3, 1, 2).contiguous()
    hints = None
    if hints_path is not None:
        hints = torch.from_numpy(load_hints(hints_path)).permute(0, 3, 1, 2).contiguous()
        if hints.shape[0] != images.shape[0] or hints.shape[2:] != images.shape[2:]:
            raise ValueError(f"hints {tuple(hints.shape)} do not match images "
                             f"{tuple(images.shape)}")
        hints = hints.to(device)
    return images.to(device), hints


def load_latents(latent_path: str) -> dict[str, np.ndarray]:
    """Every ``*.pkl`` and then every ``*.npz`` shard in ``latent_path``
    merged into one {key: moments} dict, shards in sorted order (a later
    shard's key wins).  Torch tensors become numpy arrays and batched 4-D
    entries are ``[0]``-unwrapped, as the reference's ``v[0]``.  A ``.pkl``
    shard is unpickled: read only caches that you or the reference wrote."""

    def unwrap(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        return arr[0] if arr.ndim == 4 else arr

    latents: dict[str, np.ndarray] = {}
    for f in sorted(glob.glob(os.path.join(latent_path, "*.pkl"))):
        with open(f, "rb") as fh:
            shard = pickle.load(fh)
        for k, v in shard.items():
            latents[k] = unwrap(v)
    for f in sorted(glob.glob(os.path.join(latent_path, "*.npz"))):
        with np.load(f) as shard:
            for k in shard.files:
                latents[k] = unwrap(shard[k])
    return latents


def stack_latents(latents: dict[str, np.ndarray], z_channels: int) -> np.ndarray:
    """The cache's moments in sorted key order as one float32 (N, 2z, h, w)
    array.  Entries are (2z, h, w), as the reference and this package's
    ``infer_vae`` write them; the JAX package's (h, w, 2z) shards are
    transposed."""
    if not latents:
        raise ValueError("the latent cache is empty")
    out = []
    for k in sorted(latents):
        m = np.asarray(latents[k], np.float32)
        if m.ndim != 3 or 2 * z_channels not in (m.shape[0], m.shape[-1]):
            raise ValueError(f"latent {k!r} of shape {m.shape} holds no {2 * z_channels} "
                             "moment channels")
        out.append(m if m.shape[0] == 2 * z_channels else m.transpose(2, 0, 1))
    return np.stack(out)


def moments_nchw(moments: np.ndarray, z_channels: int) -> np.ndarray:
    """A batch of cached moments as float32 (B, 2z, h, w): entries cached
    (2z, h, w), as the reference and this package's ``infer_vae`` write them,
    or (h, w, 2z), as the JAX package's do (``stack_latents``' rule)."""
    m = np.asarray(moments, np.float32)
    if m.ndim != 4 or 2 * z_channels not in (m.shape[1], m.shape[-1]):
        raise ValueError(f"moments of shape {m.shape} hold no {2 * z_channels} channels")
    return m if m.shape[1] == 2 * z_channels else m.transpose(0, 3, 1, 2)


def latents_from_batch(moments: torch.Tensor, generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """Latents drawn from (B, 2z, h, w) moments mean || logvar: mean +
    exp(logvar / 2) * noise, with standard-normal ``noise`` (the mean's
    shape) from ``generator`` unless injected.  Under a data-parallel
    ``mesh`` the moments are this rank's rows and the noise is drawn at the
    global batch's shape and sliced."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    if noise is None:
        from controlnet_tpu_torch.sample.common import global_batch, rank_rows

        b = global_batch(mean.shape[0], mesh)
        noise = rank_rows(torch.randn((b, *mean.shape[1:]), generator=generator,
                                      device=mean.device, dtype=mean.dtype), mesh)
    return mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)


# ---------------------------------------------------------------------------
# the reference's file trees
# ---------------------------------------------------------------------------


def _to_unit(im: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return (im.astype(np.float32) / 255.0) * 2.0 - 1.0


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("opencv (cv2) is required for return_hints=True; the trainer "
                           "tools take --hint_backend tpu for the port's canny on the "
                           "device instead") from e
    return cv2


def _canny_hint(im_u8: np.ndarray) -> np.ndarray:
    """``cv2.Canny(im, 100, 200)`` -> {0, 1} float32 (H, W, 3).  ``im_u8`` is
    gray (MNIST, CIFAR-10's gray conversion) or RGB (CelebA-HQ: canny on the
    per-channel gradients, as the reference does)."""
    edges = _cv2().Canny(im_u8, 100, 200)
    hint = (edges > 0).astype(np.float32)
    return np.repeat(hint[..., None], 3, axis=-1)


def _resize_center_crop(img, size: int):
    """torchvision's Resize(size) + CenterCrop(size) on a PIL image: scale
    the short side to ``size`` (the long side truncated to an int), then crop
    the center square."""
    from PIL import Image

    w, h = img.size
    if min(w, h) != size:
        nw, nh = ((size, int(size * h / w)) if w < h else (int(size * w / h), size))
        img = img.resize((nw, nh), Image.BILINEAR)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _glob_class_tree(im_path: str) -> list[str]:
    """Sorted ``<im_path>/<class>/*.png`` paths (a flat ``<im_path>/*.png``
    where there are no class directories)."""
    if not os.path.isdir(im_path):
        raise FileNotFoundError(f"image directory {im_path} does not exist")
    files = sorted(glob.glob(os.path.join(im_path, "*", "*.png")))
    if not files:
        files = sorted(glob.glob(os.path.join(im_path, "*.png")))
    return files


def _open(path: str):
    from PIL import Image

    return Image.open(path)


class MnistDataset:
    """Grayscale class-dir PNG tree -> (H, W, 1) float32 in [-1, 1] (+ the
    (H, W, 3) {0, 1} canny hint with ``return_hints``)."""

    def __init__(self, split: str, im_path: str, return_hints: bool = False):
        self.split = split
        self.return_hints = return_hints
        self.images = _glob_class_tree(im_path)
        print(f"Found {len(self.images)} images for split {split}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        im_u8 = np.asarray(_open(self.images[index]).convert("L"))
        im = _to_unit(im_u8)[..., None]
        if self.return_hints:
            return im, _canny_hint(im_u8)
        return im


class CifarDataset:
    """RGB class-dir PNG tree -> (H, W, 3) float32 in [-1, 1] (+ the canny
    hint of the gray conversion with ``return_hints``).  There is no
    download: ``controlnet_tpu/utils/extract_cifar_images.py`` writes the
    tree from the ``cifar-10-batches-py`` pickles."""

    def __init__(self, split: str, im_path: str, download: bool = False,
                 return_hints: bool = False):
        self.split = split
        self.return_hints = return_hints
        if download and not os.path.isdir(im_path):
            raise RuntimeError(
                "CIFAR-10 is not downloaded here: write the PNG tree at "
                f"{im_path} with controlnet_tpu/utils/extract_cifar_images.py from the "
                "cifar-10-batches-py pickles")
        self.images = _glob_class_tree(im_path)
        print(f"Found {len(self.images)} images for split {split}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        rgb_u8 = np.asarray(_open(self.images[index]).convert("RGB"))
        im = _to_unit(rgb_u8)
        if self.return_hints:
            cv2 = _cv2()
            return im, _canny_hint(cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2GRAY))
        return im


class CelebDataset:
    """CelebA-HQ style flat image directory (png, jpg, jpeg).

    * pixel mode: resize + center-crop to ``im_size`` -> (S, S, C) in [-1, 1];
    * latent mode (``use_latents`` and a ``latent_path`` whose cache holds
      every image): the cached encoder moments mean || logvar of the image,
      keyed by basename (full-path keys of foreign caches are accepted);
      ``self.use_latents`` says whether the cache was complete, and callers
      encode images themselves when it was not;
    * ``return_hint``: the canny hint of the raw RGB image resized and
      cropped to ``canny_im_size``."""

    def __init__(self, split: str, im_path: str, im_size: int, im_channels: int = 3,
                 use_latents: bool = False, latent_path: str | None = None,
                 return_hint: bool = False, canny_im_size: int = 1024):
        self.split = split
        self.im_path = im_path
        self.im_size = im_size
        self.im_channels = im_channels
        self.return_hint = return_hint
        self.canny_im_size = canny_im_size
        if not os.path.isdir(im_path):
            raise FileNotFoundError(f"image directory {im_path} does not exist")
        paths: list[str] = []
        for ext in ("png", "jpg", "jpeg"):
            paths += glob.glob(os.path.join(im_path, f"*.{ext}"))
        self._paths = sorted(paths)
        # basenames double as the latent cache's keys (tools/infer_vae.py)
        self.images = [os.path.basename(p) for p in self._paths]
        print(f"Found {len(self.images)} images for split {split}")

        self.use_latents = False
        self.latent_maps: dict[str, np.ndarray] = {}
        if use_latents and latent_path is not None:
            latents = load_latents(latent_path) if os.path.isdir(latent_path) else {}
            latents = {os.path.basename(k): v for k, v in latents.items()}
            if latents and all(name in latents for name in self.images):
                self.latent_maps = latents
                self.use_latents = True
                print(f"Found latents for {len(latents)} images")
            else:
                print("Latents not found (or incomplete) — falling back to images")

    def __len__(self) -> int:
        return len(self.images)

    def _load_hint(self, img) -> np.ndarray:
        img = _resize_center_crop(img.convert("RGB"), self.canny_im_size)
        return _canny_hint(np.asarray(img))

    def __getitem__(self, index: int):
        path = self._paths[index]
        src = None  # decoded at most once: PIL keeps the raster after a convert
        if self.use_latents:
            item = self.latent_maps[self.images[index]].astype(np.float32)
        else:
            src = _open(path)
            mode = "RGB" if self.im_channels == 3 else "L"
            arr = np.asarray(_resize_center_crop(src.convert(mode), self.im_size))
            if arr.ndim == 2:
                arr = arr[..., None]
            item = _to_unit(arr)
        if self.return_hint:
            return item, self._load_hint(src if src is not None else _open(path))
        return item


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous().to(device)


class ImageSource:
    """One split as a tool iterates it: ``.npy`` images (and hints) held on
    ``device``, or a reader whose NHWC batches are decoded on a host thread
    and moved to ``device`` as NCHW batch by batch.  Both give the same
    batches in the same order for a seed, when the array holds the reader's
    items in the reader's order."""

    def __init__(self, images: torch.Tensor | None = None, hints: torch.Tensor | None = None,
                 dataset=None, device=None):
        if (images is None) == (dataset is None):
            raise ValueError("an ImageSource holds arrays or a reader, not both")
        self.images, self.hints, self.dataset, self.device = images, hints, dataset, device

    @classmethod
    def from_npy(cls, images_path: str, hints_path: str | None, device) -> "ImageSource":
        images, hints = load_split(images_path, hints_path, device)
        return cls(images=images, hints=hints, device=device)

    @classmethod
    def from_reader(cls, dataset, device) -> "ImageSource":
        return cls(dataset=dataset, device=device)

    def __len__(self) -> int:
        return len(self.dataset) if self.dataset is not None else len(self.images)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, rows=None):
        """(images, hints or None) NCHW float32 on the device, one epoch;
        ``rows`` as in ``iterate_batches`` (only those items are read)."""
        if self.dataset is None:
            # the batches of the items' indices, to take images and hints alike
            order = torch.arange(len(self.images), device=self.images.device)
            for idx in iterate_batches(order, batch_size, shuffle, seed, rows=rows):
                yield self.images[idx], None if self.hints is None else self.hints[idx]
            return
        for batch in iterate_batches(self.dataset, batch_size, shuffle, seed, rows=rows):
            if isinstance(batch, tuple):
                yield _nchw(batch[0], self.device), _nchw(batch[1], self.device)
            else:
                yield _nchw(batch, self.device), None

    def first(self, n: int, seed: int = 0):
        """The first shuffled batch of ``min(n, len(self))`` items, as the
        JAX sample tools draw their test batch."""
        batches = self.batches(min(n, len(self)), shuffle=True, seed=seed)
        try:
            return next(batches)
        finally:
            batches.close()
