"""The port's data layer against the JAX package's on the same scenes on
disk: all ten loaders (poses, directions, rays, img_wh and K equal in
float32, through the decoders the JAX twins use), `read_pfm`, the same
scenes read with imageio, cv2, PIL and the native library all hidden
(the port's PNG and JPEG codecs and `resize_linear`), the port's PNG
codec against imageio, `resize_linear` against cv2, the header reader,
the turbo colormap against cv2, and the errors that name a missing
library."""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from radnerf_tpu.data import dataset_dict as jax_datasets
from radnerf_tpu.data.depth_utils import read_pfm as j_read_pfm
from radnerf_tpu_torch.data import color_utils, dataset_dict, native, png
from radnerf_tpu_torch.data.depth_utils import read_pfm

from .fixtures import make_nsvf_dataset
from .test_data_loaders import (
    W0, H0, _circle_pose, _write_colmap_model, _write_img,
)

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
    """The registry holds the reference's ten keys, each a loader, and no
    other key."""
    assert set(dataset_dict) == set(jax_datasets)
    assert all(callable(v) for v in dataset_dict.values())
    with pytest.raises(KeyError):
        dataset_dict["blender"]


# ------------------------------------------------- the seven other loaders
def _c2w(i, n):
    return np.concatenate([_circle_pose(i, n), [[0, 0, 0, 1]]], axis=0)


def _nerfpp_scene(root):
    """tests/test_data_loaders.py::test_nerfpp's layout."""
    for s, n in (("train", 5), ("val", 2), ("test", 3)):
        os.makedirs(os.path.join(root, s, "pose"), exist_ok=True)
        for i in range(n):
            _write_img(os.path.join(root, s, "rgb", f"{i:05d}.png"), seed=i)
            np.savetxt(os.path.join(root, s, "pose", f"{i:05d}.txt"),
                       _c2w(i, n).reshape(-1))
    K = np.array([[35.0, 0, W0 / 2, 0], [0, 35.0, H0 / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    os.makedirs(os.path.join(root, "train/intrinsics"))
    np.savetxt(os.path.join(root, "train/intrinsics/00000.txt"),
               K.reshape(-1))
    os.makedirs(os.path.join(root, "camera_path/pose"))
    for i in range(4):
        np.savetxt(os.path.join(root, "camera_path/pose", f"{i:05d}.txt"),
                   _c2w(i, 4).reshape(-1))
    return dict(downsample=0.5)


def _scannet_scene(root):
    """test_scannet's layout: 128x96 JPEGs (a 24-pixel border unpadded,
    then resized), one inf pose."""
    os.makedirs(os.path.join(root, "poses"))
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               np.array([[35.0, 0, W0 / 2, 0], [0, 35.0, H0 / 2, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]]))
    for i in range(18):
        _write_img(os.path.join(root, "images", f"{i:04d}.jpg"), w=128,
                   h=96, seed=i)
        c2w = _c2w(i, 18)
        if i == 3:
            c2w[:3] = np.inf
        np.savetxt(os.path.join(root, "poses", f"{i:04d}.txt"), c2w)
    return dict(downsample=0.05)


def _eyeful_scene(root):
    """test_eyeful's layout: cameras.json KRT, splits.json, JPEGs resized
    to 684x1024 x downsample."""
    os.makedirs(os.path.join(root, "images"))
    K = np.array([[35.0, 0, W0 / 2], [0, 35.0, H0 / 2], [0, 0, 1]])
    krt = []
    for i in range(5):
        krt.append({"cameraId": f"cam{i}", "width": W0, "height": H0,
                    "K": K.T.tolist(),
                    "T": np.linalg.inv(_c2w(i, 5)).T.tolist()})
        _write_img(os.path.join(root, "images", f"cam{i}.jpg"), seed=i)
    with open(os.path.join(root, "cameras.json"), "w") as f:
        json.dump({"KRT": krt}, f)
    with open(os.path.join(root, "splits.json"), "w") as f:
        json.dump({"train": ["cam0", "cam1", "cam2"],
                   "test": ["cam3", "cam4"]}, f)
    return dict(downsample=0.05)


def _nerf_scene(root):
    """A Blender-layout scene: transforms_{train,val,test}.json and RGBA
    PNGs at 800 x downsample (one test frame has no image), in a Jrender
    'Coffee' directory, whose radius and shift the loader applies."""
    root = os.path.join(root, "Jrender_Dataset", "Coffee")
    rng = np.random.default_rng(0)
    for s, n in (("train", 4), ("val", 2), ("test", 3)):
        frames = []
        for i in range(n):
            name = f"{s}/r_{i}"
            if not (s == "test" and i == 2):
                os.makedirs(os.path.join(root, s), exist_ok=True)
                imageio.imwrite(os.path.join(root, name + ".png"),
                                rng.integers(0, 256, (32, 32, 4), np.uint8))
            frames.append({"file_path": name,
                           "transform_matrix": _c2w(i, n).tolist()})
        with open(os.path.join(root, f"transforms_{s}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return dict(root_dir=root, downsample=0.04)


def _rtmv_scene(root):
    """test_rtmv's layout, in a 'bricks' directory (the box
    normalization)."""
    os.makedirs(os.path.join(root, "images"))
    for i in range(6):
        meta = {"camera_data": {
            "scene_center_3d_box": [0.5, -0.25, 0.0],
            "scene_min_3d_box": [-5.0, -5.0, -5.0],
            "scene_max_3d_box": [5.0, 5.0, 5.0],
            "intrinsics": {"fx": 35.0, "fy": 35.0, "cx": W0 / 2,
                           "cy": H0 / 2},
            "width": W0, "height": H0, "cam2world": _c2w(i, 6).T.tolist()}}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        _write_img(os.path.join(root, "images", f"{i:05d}.png"), seed=i)
    return dict(downsample=0.5)


def _replica_scene(root):
    """test_replica's layout: transforms.json, JPEGs, poses, traj.txt."""
    os.makedirs(os.path.join(root, "poses"))
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"w": W0, "h": H0, "fl_x": 35.0, "fl_y": 35.0}, f)
    for i in range(8):
        _write_img(os.path.join(root, "images", f"{i:04d}.jpg"), seed=i)
        np.savetxt(os.path.join(root, "poses", f"{i:04d}.txt"), _c2w(i, 8))
    traj = np.stack([_c2w(i, 6) for i in range(6)])
    np.savetxt(os.path.join(root, "traj.txt"), traj.reshape(6, -1))
    return dict(downsample=0.75)


def _mill19_scene(root):
    """test_mill19's layout ('building': the altitude offsets), .pt
    metadata and JPEG rgbs/."""
    os.makedirs(os.path.join(root, "train/metadata"))
    torch.save({"origin_drb": torch.tensor([10.0, 20.0, 30.0]),
                "pose_scale_factor": 50.0},
               os.path.join(root, "coordinates.pt"))
    for i in range(4):
        _write_img(os.path.join(root, "train/rgbs", f"{i + 1:06d}.jpg"),
                   seed=i)
        torch.save({"W": W0, "H": H0,
                    "intrinsics": torch.tensor([35.0, 35.0, W0 / 2, H0 / 2]),
                    "c2w": torch.tensor(_circle_pose(i, 4),
                                        dtype=torch.float64)},
                   os.path.join(root, "train/metadata", f"{i + 1:06d}.pt"))
    return dict(downsample=1.0)


SCENES = {
    "nerfpp": ("tat", _nerfpp_scene, ["train", "trainval", "test",
                                      "test_traj"]),
    "scannet": ("scan", _scannet_scene, ["train", "test", "test_traj"]),
    "eyeful": ("eyeful", _eyeful_scene, ["train", "test"]),
    "nerf": ("blender", _nerf_scene, ["train", "val", "test", "trainval"]),
    "rtmv": ("rtmv-bricks", _rtmv_scene, ["train", "trainval"]),
    "replica": ("replica", _replica_scene, ["train", "test", "test_traj"]),
    "mill19": ("mill19-building", _mill19_scene, ["train", "test"]),
}
LOADER_SPLITS = [(k, s) for k, (_, _, splits) in SCENES.items()
                 for s in splits]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Every loader's scene on disk: key -> loader kwargs."""
    base = tmp_path_factory.mktemp("scenes")
    out = {}
    for key, (name, write, _) in SCENES.items():
        root = str(base / name)
        os.makedirs(root, exist_ok=True)
        out[key] = {"root_dir": root, **write(root)}
    return out


def _same_or_no_rays(port, ref, split):
    if split == "test_traj":
        for f in ("poses", "directions", "K"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                          err_msg=f)
        assert tuple(port.img_wh) == tuple(ref.img_wh)
    else:
        _same(port, ref)


@pytest.mark.parametrize("key,split", LOADER_SPLITS)
def test_loader_equals_jax(scenes, key, split):
    """Each of the seven loaders against its JAX twin on the fixture
    layouts, both reading through imageio and cv2 (scannet through the
    native decoder, as its twin's read_images does)."""
    kw = dict(scenes[key], split=split)
    port, ref = dataset_dict[key](**kw), jax_datasets[key](**kw)
    _same_or_no_rays(port, ref, split)
    if split != "test_traj" or key == "scannet":
        assert port.decoder == ("native" if key == "scannet" else "imageio")


def test_rtmv_split_past_the_frames_fails_as_in_jax(scenes):
    """Six frames: rtmv's test split (frames 105-149) is empty, and both
    loaders fail to stack it."""
    kw = dict(scenes["rtmv"], split="test")
    with pytest.raises(ValueError):
        jax_datasets["rtmv"](**kw)
    with pytest.raises(ValueError):
        dataset_dict["rtmv"](**kw)


def test_read_pfm_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    for header, data, scale in ((b"Pf", rng.random((6, 8)).astype("<f4"),
                                 -1.0),
                                (b"PF", rng.random((5, 7, 3)).astype(">f4"),
                                 2.5)):
        p = str(tmp_path / "d.pfm")
        h, w = data.shape[:2]
        with open(p, "wb") as f:
            f.write(header + f"\n{w} {h}\n{scale}\n".encode())
            f.write(data.tobytes())
        got, got_scale = read_pfm(p)
        want, want_scale = j_read_pfm(p)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.flipud(data))
        assert got_scale == want_scale == abs(scale)


# cv2's INTER_LINEAR against resize_linear on [0, 1] images: equal, or
# (in under 1% of the values at ratios near 2 and at large upscales) one
# rounding apart, at most 2^-24 observed; held at 2^-23
RESIZE_ATOL = 2.0 ** -23


@pytest.mark.parametrize("key", list(SCENES))
def test_without_libraries_the_loaders_read_their_scenes(scenes, key,
                                                         monkeypatch):
    """Each loader with imageio, cv2, PIL and the native library hidden
    (the card's machine): the port's codecs decode every image as
    imageio does and resize_linear resizes it within RESIZE_ATOL of cv2;
    the decoder is recorded."""
    split = SCENES[key][2][0]
    kw = dict(scenes[key], split=split)
    monkeypatch.setattr(native, "load_images", lambda *a, **k: None)
    want = dataset_dict[key](**kw)              # imageio and cv2
    monkeypatch.setattr(color_utils, "_imageio", lambda: None)
    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    got = dataset_dict[key](**kw)
    for f in ("poses", "directions", "K"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert tuple(got.img_wh) == tuple(want.img_wh)
    assert got.rays.shape == want.rays.shape
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=RESIZE_ATOL)
    jpg = key in ("scannet", "eyeful", "replica", "mill19")
    assert got.decoder == ("jpeg codec" if jpg else "png codec")


@pytest.mark.parametrize("src,dst", [
    ((1248, 920), (648, 484)),      # scannet at downsample 0.5, unpadded
    ((1368, 2048), (342, 512)),     # eyeful at downsample 0.5
    ((40, 30), (342, 512)),         # the eyeful fixture
    ((80, 48), (64, 48)),           # the scannet fixture, unpadded
    ((40, 30), (80, 60)),           # 2x up
    ((40, 30), (20, 15)),           # 0.5x down
    ((41, 31), (20, 15)),
    ((50, 40), (648, 484))])
def test_resize_linear_equals_cv2(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = rng.random((src[1], src[0], 3)).astype(np.float32)
    got = color_utils.resize_linear(img, dst)
    want = cv2.resize(img, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    # most values are bit-equal
    assert np.mean(got == want) > 0.99


def test_image_size_reads_the_headers(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for name, shape in (("a.png", (13, 29, 3)), ("b.jpg", (31, 17, 3)),
                        ("c.png", (7, 5))):
        p = str(tmp_path / name)
        imageio.imwrite(p, rng.integers(0, 256, shape, np.uint8))
        paths.append((p, (shape[1], shape[0])))
    for p, wh in paths:
        assert color_utils.image_size(p) == wh == Image.open(p).size
    monkeypatch.setitem(sys.modules, "PIL", None)
    for p, wh in paths:
        assert color_utils.image_size(p) == wh


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
    """Without imageio and cv2, PNG and JPEG files are read by the port's
    codecs (by their magic bytes, whatever their extension) and resized
    by resize_linear; a file of any other format raises ImportError
    naming imageio, and its size one naming PIL."""
    img = np.random.default_rng(0).integers(0, 256, (10, 12, 3), np.uint8)
    png_path, jpg_path = str(tmp_path / "a.png"), str(tmp_path / "a.jpg")
    imageio.imwrite(png_path, img)
    imageio.imwrite(jpg_path, img)
    misnamed = str(tmp_path / "jpeg_named.png")
    imageio.imwrite(misnamed, img, format="JPEG")
    bmp_path = str(tmp_path / "a.bmp")
    imageio.imwrite(bmp_path, img)
    want = {p: color_utils.read_image(p, (6, 5))
            for p in (png_path, jpg_path, misnamed)}
    monkeypatch.setattr(color_utils, "_imageio", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    monkeypatch.setitem(sys.modules, "PIL", None)
    for p, w in want.items():
        np.testing.assert_allclose(color_utils.read_image(p, (6, 5)), w,
                                   rtol=0, atol=RESIZE_ATOL)
    assert color_utils.python_decoder(misnamed) == "jpeg codec"
    with pytest.raises(ImportError, match="imageio.*native"):
        color_utils.read_image(bmp_path, (12, 10))
    with pytest.raises(ImportError, match="PIL"):
        color_utils.image_size(bmp_path)
