"""The port's readers (controlnet_tpu_torch/data/datasets.py) against the JAX
package's on trees written by the JAX generator
(``controlnet_tpu/data/synthetic.py``).

Exact throughout: the items (MNIST gray, CIFAR-10 RGB, CelebA-HQ resize and
center-crop, the latent mode's cached moments) and the cv2 canny hints are
equal bit for bit, ``iterate_batches`` gives the same batches in the same
order for a seed with prefetch on and off, ``build_dataset`` picks the same
reader, and the port's own ``synthetic.py`` writes the same PNGs as the JAX
generator for a seed.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from controlnet_tpu import cli as jax_cli
from controlnet_tpu.data import datasets as jd
from controlnet_tpu.data.synthetic import make_synthetic_image_tree as jax_tree
from controlnet_tpu_torch import cli
from controlnet_tpu_torch.data import datasets as pd
from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree as port_tree


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    mnist = jax_tree(str(root / "mnist"), num_classes=3, per_class=5, size=28, channels=1,
                     seed=1)
    cifar = jax_tree(str(root / "cifar"), num_classes=2, per_class=6, size=32, channels=3,
                     seed=2)
    # a flat CelebA-HQ style directory of non-square RGB images
    celeb = root / "celeb"
    celeb.mkdir()
    rng = np.random.default_rng(3)
    for i, (w, h) in enumerate([(48, 40), (40, 56), (36, 36), (64, 50), (50, 64)]):
        arr = (rng.uniform(size=(h, w, 3)) > 0.6).astype(np.uint8) * 220
        Image.fromarray(arr).save(celeb / f"im_{i:02d}.{'png' if i % 2 else 'jpg'}")
    return {"mnist": mnist, "cifar": cifar, "celeb": str(celeb)}


def _pairs(trees, hints: bool):
    yield (pd.MnistDataset("train", trees["mnist"], return_hints=hints),
           jd.MnistDataset("train", trees["mnist"], return_hints=hints))
    yield (pd.CifarDataset("train", trees["cifar"], return_hints=hints),
           jd.CifarDataset("train", trees["cifar"], return_hints=hints))
    yield (pd.CelebDataset("train", trees["celeb"], im_size=24, return_hint=hints,
                           canny_im_size=32),
           jd.CelebDataset("train", trees["celeb"], im_size=24, return_hint=hints,
                           canny_im_size=32))


@pytest.mark.parametrize("hints", [False, True], ids=["items", "items-and-cv2-hints"])
def test_readers_equal_jax_bit_for_bit(trees, hints):
    for mine, ref in _pairs(trees, hints):
        assert len(mine) == len(ref) > 0
        assert list(mine.images) == list(ref.images)
        for i in range(len(ref)):
            a, b = mine[i], ref[i]
            if hints:
                assert len(a) == len(b) == 2
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype == np.float32
                    np.testing.assert_array_equal(x, y)
                assert set(np.unique(a[1])) <= {0.0, 1.0}
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_item_shapes(trees):
    m, c, e = (mine for mine, _ in _pairs(trees, True))
    assert m[0][0].shape == (28, 28, 1) and m[0][1].shape == (28, 28, 3)
    assert c[0][0].shape == (32, 32, 3) and c[0][1].shape == (32, 32, 3)
    assert e[0][0].shape == (24, 24, 3) and e[0][1].shape == (32, 32, 3)
    assert e[0][0].min() >= -1 and e[0][0].max() <= 1


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("batch", [4, 5, 100], ids=["b4", "b5-drops-tail", "b100-short"])
def test_iterate_batches_same_order_as_jax(trees, prefetch, batch):
    mine = pd.CifarDataset("train", trees["cifar"], return_hints=True)
    ref = jd.CifarDataset("train", trees["cifar"], return_hints=True)
    got = list(pd.iterate_batches(mine, batch, shuffle=True, seed=11, prefetch=prefetch))
    want = list(jd.iterate_batches(ref, batch, shuffle=True, seed=11, prefetch=prefetch))
    assert len(got) == len(want) == max(1, len(ref) // batch)
    for (a_im, a_h), (b_im, b_h) in zip(got, want):
        np.testing.assert_array_equal(a_im, b_im)
        np.testing.assert_array_equal(a_h, b_h)


def test_iterate_batches_over_arrays_and_tensors_keeps_working():
    data = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    a = list(pd.iterate_batches(data, 4, shuffle=True, seed=5))
    t = list(pd.iterate_batches(torch.from_numpy(data), 4, shuffle=True, seed=5))
    order = np.random.default_rng(5).permutation(10)
    assert len(a) == len(t) == 2
    for i, (x, y) in enumerate(zip(a, t)):
        np.testing.assert_array_equal(x, data[order[4 * i:4 * i + 4]])
        np.testing.assert_array_equal(y.numpy(), x)


def test_prefetch_thread_stops_when_the_consumer_does(trees):
    import threading

    ds = pd.MnistDataset("train", trees["mnist"])
    before = threading.active_count()
    gen = pd.iterate_batches(ds, 2, shuffle=True, seed=0, prefetch=1)
    next(gen)
    gen.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_reader_errors_reach_the_consumer(trees):
    class Broken(pd.MnistDataset):
        def __getitem__(self, index):
            raise OSError("unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(pd.iterate_batches(Broken("train", trees["mnist"]), 2, prefetch=2))


def _jax_cache(path, names, layout_hw_last=True, full_paths=False, root=""):
    """A latent cache as the JAX infer_vae writes it: npz shards of
    basename-keyed (h, w, 2z) moments."""
    rng = np.random.default_rng(4)
    os.makedirs(path, exist_ok=True)
    shard = {}
    for n in names:
        m = rng.standard_normal((3, 3, 4) if layout_hw_last else (4, 3, 3)).astype(np.float32)
        shard[os.path.join(root, n) if full_paths else n] = m
    np.savez(os.path.join(path, "latents_0.npz"), **shard)


@pytest.mark.parametrize("full_paths", [False, True], ids=["basename-keys", "full-path-keys"])
def test_celeb_latent_mode_reads_a_jax_written_cache(trees, tmp_path, full_paths):
    ref0 = jd.CelebDataset("train", trees["celeb"], im_size=24)
    cache = str(tmp_path / "lat")
    _jax_cache(cache, ref0.images, full_paths=full_paths, root=trees["celeb"])
    kw = dict(im_size=24, use_latents=True, latent_path=cache)
    mine = pd.CelebDataset("train", trees["celeb"], **kw)
    ref = jd.CelebDataset("train", trees["celeb"], **kw)
    assert mine.use_latents and ref.use_latents
    for i in range(len(ref)):
        np.testing.assert_array_equal(mine[i], ref[i])
    batch = next(pd.iterate_batches(mine, 2))
    np.testing.assert_array_equal(pd.moments_nchw(batch, 2), batch.transpose(0, 3, 1, 2))


def test_celeb_incomplete_cache_falls_back_to_images(trees, tmp_path):
    names = jd.CelebDataset("train", trees["celeb"], im_size=24).images
    cache = str(tmp_path / "lat")
    _jax_cache(cache, names[:-1])
    kw = dict(im_size=24, use_latents=True, latent_path=cache)
    mine = pd.CelebDataset("train", trees["celeb"], **kw)
    ref = jd.CelebDataset("train", trees["celeb"], **kw)
    assert not mine.use_latents and not ref.use_latents
    np.testing.assert_array_equal(mine[0], ref[0])
    assert mine[0].shape == (24, 24, 3)


@pytest.mark.parametrize("dataset_config,task,split,kind", [
    ({"task_name": "mnist"}, "anything", "train", "MnistDataset"),
    ({"name": "cifar10"}, "out/dir", "test", "CifarDataset"),
    ({}, "mnist", "test", "MnistDataset"),
    ({"name": "celebhq", "im_size": 24}, "x", "train", "CelebDataset"),
])
def test_build_dataset_picks_the_jax_reader(trees, dataset_config, task, split, kind):
    kind_key = dataset_config.get("task_name", dataset_config.get("name", task))
    path = trees[{"mnist": "mnist", "cifar10": "cifar", "celebhq": "celeb"}[kind_key]]
    dc = dict(dataset_config, im_path=path, im_test_path=path)
    mine = cli.build_dataset(task, dc, split, return_hints=False)
    ref = jax_cli.build_dataset(task, dc, split, return_hints=False)
    assert type(mine).__name__ == type(ref).__name__ == kind
    assert mine.split == ref.split == split
    np.testing.assert_array_equal(mine[0], ref[0])
    with pytest.raises(ValueError, match="Invalid dataset"):
        cli.build_dataset("imagenet", {}, split)


@pytest.mark.parametrize("channels,size", [(1, 28), (3, 32)])
def test_port_synthetic_tree_equals_jax(tmp_path, channels, size):
    a = port_tree(str(tmp_path / "port"), num_classes=2, per_class=4, size=size,
                  channels=channels, seed=7)
    b = jax_tree(str(tmp_path / "jax"), num_classes=2, per_class=4, size=size,
                 channels=channels, seed=7)
    files = sorted(os.path.relpath(f, a) for f in pd._glob_class_tree(a))
    assert files == sorted(os.path.relpath(f, b) for f in jd._glob_class_tree(b))
    assert len(files) == 8
    for f in files:
        x, y = Image.open(os.path.join(a, f)), Image.open(os.path.join(b, f))
        assert x.mode == y.mode
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_hints_without_cv2_raise_naming_the_device_backend(trees, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    ds = pd.MnistDataset("train", trees["mnist"], return_hints=True)
    with pytest.raises(RuntimeError, match="--hint_backend tpu"):
        ds[0]
    np.testing.assert_array_equal(pd.MnistDataset("train", trees["mnist"])[0],
                                  jd.MnistDataset("train", trees["mnist"])[0])


def test_image_source_gives_the_same_batches_from_npy_and_tree(trees, tmp_path):
    """The tools' two routes: an .npy of the tree's images in the reader's
    order gives the tree route's NCHW batches, bit for bit."""
    ds = pd.CifarDataset("train", trees["cifar"])
    u8 = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in ds.images])
    np.save(tmp_path / "x.npy", u8)
    tree = pd.ImageSource.from_reader(ds, "cpu")
    npy = pd.ImageSource.from_npy(str(tmp_path / "x.npy"), None, "cpu")
    assert len(tree) == len(npy) == 12
    for (a, ha), (b, hb) in zip(tree.batches(5, seed=3), npy.batches(5, seed=3)):
        assert ha is None and hb is None and a.shape == (5, 3, 32, 32)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    first, _ = tree.first(4, seed=9)
    torch.testing.assert_close(first, next(npy.batches(4, seed=9))[0], rtol=0, atol=0)
