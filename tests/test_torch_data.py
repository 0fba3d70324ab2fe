"""The port's data layer against the JAX package's on the same scenes on
disk: the nsvf, colmap and 360v2 loaders (poses, directions, rays,
img_wh and K equal in float32, both through the native decoder), the
port's PNG codec against imageio, the turbo colormap against cv2, and
the errors that name a missing library."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from radnerf_tpu.data import dataset_dict as jax_datasets
from radnerf_tpu_torch.data import color_utils, dataset_dict, native, png

from .fixtures import make_nsvf_dataset
from .test_data_loaders import W0, H0, _write_colmap_model, _write_img

imageio = pytest.importorskip("imageio.v2")
cv2 = pytest.importorskip("cv2")

FIELDS = ("poses", "directions", "rays", "img_wh", "K")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if f == "img_wh":
            assert tuple(x) == tuple(y)
        else:
            assert x.dtype == y.dtype == np.float32, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def nsvf_root(tmp_path_factory):
    return make_nsvf_dataset(str(tmp_path_factory.mktemp("nsvf")))


@pytest.mark.parametrize("split", ["train", "test", "trainval"])
def test_nsvf_loader_equals_jax(nsvf_root, split):
    kw = dict(root_dir=nsvf_root, split=split, downsample=32 / 800)
    port, ref = dataset_dict["nsvf"](**kw), jax_datasets["nsvf"](**kw)
    _same(port, ref)
    assert port.decoder == "native"


def test_nsvf_tanks_family_and_test_traj(tmp_path):
    """The Tanks branch (a 4x4 intrinsics matrix at 1920x1080, scaled by
    the downsample) and the test_traj split, against JAX."""
    root = str(tmp_path / "TanksAndTemple" / "Scene")
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               [[1100.0, 0, 960, 0], [0, 1100.0, 540, 0], [0, 0, 1, 0],
                [0, 0, 0, 1]])
    np.savetxt(os.path.join(root, "bbox.txt"),
               [[-1.0, -0.8, -0.5, 1.0, 0.9, 0.7, 0.01]])
    rng = np.random.default_rng(0)
    for name in ("0_0000", "0_0001", "1_0000"):
        imageio.imwrite(os.path.join(root, "rgb", name + ".png"),
                        rng.integers(0, 256, (27, 48, 3), np.uint8))
        np.savetxt(os.path.join(root, "pose", name + ".txt"),
                   np.vstack([rng.normal(size=(3, 4)), [0, 0, 0, 1]]))
    np.savetxt(os.path.join(root, "test_traj.txt"),
               np.tile(np.eye(4), (3, 1)))
    for split in ("train", "test", "test_traj"):
        kw = dict(root_dir=root, split=split, downsample=0.025)
        port, ref = dataset_dict["nsvf"](**kw), jax_datasets["nsvf"](**kw)
        assert port.img_wh == (48, 27)
        if split == "test_traj":
            for f in ("poses", "directions", "K"):
                np.testing.assert_array_equal(getattr(port, f),
                                              getattr(ref, f))
        else:
            _same(port, ref)


@pytest.mark.parametrize("split,num_view", [("train", 0), ("test", 0),
                                            ("train", 3)])
def test_colmap_loader_equals_jax(tmp_path, split, num_view):
    root = str(tmp_path / "scene")
    _write_colmap_model(root)
    kw = dict(root_dir=root, split=split, num_view=num_view)
    np.random.seed(0)          # num_view draws from numpy's global RNG
    port = dataset_dict["colmap"](**kw)
    np.random.seed(0)
    ref = jax_datasets["colmap"](**kw)
    _same(port, ref)
    np.testing.assert_array_equal(port.bbox, ref.bbox)
    np.testing.assert_array_equal(port.bds, ref.bds)


def test_360v2_loader_equals_jax(tmp_path):
    root = str(tmp_path / "360_v2_scene")
    _write_colmap_model(root)
    for i in range(10):
        _write_img(os.path.join(root, "images_2", f"im{i:02d}.png"),
                   W0 // 2, H0 // 2, seed=i)
    for split in ("train", "test"):
        kw = dict(root_dir=root, split=split, downsample=0.5)
        _same(dataset_dict["360v2"](**kw), jax_datasets["360v2"](**kw))
    kw = dict(root_dir=root, split="test_traj", downsample=0.5)
    port, ref = dataset_dict["360v2"](**kw), jax_datasets["360v2"](**kw)
    np.testing.assert_array_equal(port.poses, ref.poses)


def test_registry_has_the_reference_keys_and_refuses_the_rest():
    assert set(dataset_dict) == set(jax_datasets)
    for key in ("nerf", "nerfpp", "rtmv", "scannet", "replica", "mill19",
                "eyeful"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            dataset_dict[key](root_dir="nowhere", split="train")


# ---------------------------------------------------------------- codec --
def _filter_row(kind, cur, prev, bpp):
    """PNG's forward row filter `kind` (the encoder side of _unfilter)."""
    cur, prev = cur.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
    return ((cur - pred) % 256).astype(np.uint8)


def _png_with_filters(img, kinds):
    """PNG bytes of uint8 `img` whose row y uses filter kinds[y % len]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c)
    raw, prev = b"", np.zeros(w * c, np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        raw += bytes([kind]) + _filter_row(kind, rows[y], prev, c).tobytes()
        prev = rows[y]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4)])
def test_png_codec_decodes_as_imageio(tmp_path, channels, kinds):
    rng = np.random.default_rng(channels * 10 + len(kinds))
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    # a smooth ramp plus noise, so that every predictor matters
    img = ((np.arange(13)[:, None] * 7 + np.arange(17)[None] * 3)[
        (...,) + (None,) * (channels > 1)] + rng.integers(0, 60, shape)
    ).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img, kinds))
    got = png.read_png(path)
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == np.uint8


@pytest.mark.parametrize("shape", [(20, 31), (20, 31, 3), (20, 31, 4)])
def test_png_codec_reads_imageio_files_and_writes_files_imageio_reads(
        tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "im.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(png.read_png(path), imageio.imread(path))
    if len(shape) == 3 and shape[2] == 4:
        with pytest.raises(ValueError):
            png.write_png(path, img)
        return
    png.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_png_codec_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    data = bytearray(png.encode_png(np.zeros((4, 4), np.uint8)))
    data[-20] ^= 0xFF                       # a byte of the IDAT chunk
    with pytest.raises(ValueError):
        png.decode_png(bytes(data))


def test_depth2img_equals_cv2_turbo():
    rng = np.random.default_rng(0)
    for depth in (rng.random((27, 40)) * 5, rng.random((8, 9)).astype(
            np.float32), np.full((3, 3), 2.0)):
        d = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
        want = cv2.applyColorMap((d * 255).astype(np.uint8),
                                 cv2.COLORMAP_TURBO)
        np.testing.assert_array_equal(color_utils.depth2img(depth), want)


def test_without_imageio_and_native_the_codec_reads_the_scene(
        nsvf_root, monkeypatch):
    paths = sorted(os.path.join(nsvf_root, "rgb", p)
                   for p in os.listdir(os.path.join(nsvf_root, "rgb")))
    want, dec = color_utils.read_images_with_decoder(paths, (32, 32))
    assert dec == "native"
    monkeypatch.setattr(native, "load_images", lambda *a, **k: None)
    via_imageio, dec = color_utils.read_images_with_decoder(paths, (32, 32))
    assert dec == "imageio"
    monkeypatch.setattr(color_utils, "_imageio", lambda: None)
    got, dec = color_utils.read_images_with_decoder(paths, (32, 32))
    assert dec == "png codec"
    np.testing.assert_array_equal(got, via_imageio)
    np.testing.assert_array_equal(got, want)
    ds = dataset_dict["nsvf"](root_dir=nsvf_root, split="train",
                              downsample=32 / 800)
    assert ds.decoder == "png codec"


def test_read_image_names_the_missing_library(tmp_path, monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (10, 12, 3), np.uint8)
    png_path, jpg_path = str(tmp_path / "a.png"), str(tmp_path / "a.jpg")
    imageio.imwrite(png_path, img)
    imageio.imwrite(jpg_path, img)
    monkeypatch.setattr(color_utils, "_imageio", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    assert color_utils.read_image(png_path, (12, 10)).shape == (120, 3)
    with pytest.raises(ImportError, match="cv2"):
        color_utils.read_image(png_path, (6, 5))
    with pytest.raises(ImportError, match="imageio.*native"):
        color_utils.read_image(jpg_path, (12, 10))
