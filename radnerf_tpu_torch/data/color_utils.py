"""Image IO and color-space helpers (twin of radnerf_tpu/data/color_utils.py).

Images are decoded by the native library (data/native.py) when it loads
and the loader's JAX twin reads through it, else by imageio, else by the
port's own codecs (data/png.py, data/jpeg.py), chosen by the file's magic
bytes; each loader records which one read its images. A resize takes
cv2's INTER_LINEAR where cv2 is installed, else `resize_linear`. The
turbo colormap of `depth2img` is a copy of cv2's 256-entry table, so it
needs no cv2.
"""

from __future__ import annotations

import numpy as np

from . import jpeg, png

# cv2's COLORMAP_TURBO (256 RGB entries, 8 bits each)
_TURBO_HEX = (
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c3286"
    "3d358b3e38913f3b973f3e9c4040a24143a74146ac4249b1424bb5434eba4451bf4454c3"
    "4456c74559cb455ccf455ed34661d64664da4666dd4669e0466be3476ee64771e94773eb"
    "4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff5"
    "2fb2f42eb4f22cb7f02ab9ee28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda"
    "1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc518ddc218dec018e0bd19e2bb"
    "19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb73"
    "5dfc6f61fc6c65fd6969fd666dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e"
    "8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3da4fc3ca7fc3aa9fb39acfb38"
    "affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938"
    "e7d739e9d539ebd339ecd13aeecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13a"
    "f8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35fdac34fea933fea732fea431"
    "fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13"
    "f05b12ef5811ed5510ec530feb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109"
    "df3f08dd3d08dc3b07da3907d83706d63506d43305d23105d02f05ce2d04cc2b04ca2a04"
    "c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b0902880802"
    "8507028106027e05027a0403"
)
TURBO_RGB = np.frombuffer(bytes.fromhex(_TURBO_HEX), np.uint8).reshape(256, 3)


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    return imageio


def _codec(head: bytes):
    """The port's codec for a file starting with `head`: (name, decode,
    size from the header), or None."""
    if head.startswith(png.SIGNATURE):
        return "png codec", png.decode_png, png.png_size
    if head.startswith(jpeg.SOI):
        return "jpeg codec", jpeg.decode_jpeg, jpeg.jpeg_size
    return None


def _head(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(8)


def python_decoder(path: str) -> str:
    """The decoder `imread` takes for `path`: 'imageio', or the port's
    'png codec' or 'jpeg codec'."""
    if _imageio() is not None:
        return "imageio"
    codec = _codec(_head(path))
    return codec[0] if codec else "none"


def imread(path: str) -> np.ndarray:
    """uint8 (H, W) or (H, W, C), as imageio.imread gives it: imageio
    where it is installed, else the port's PNG or JPEG codec, chosen by
    the file's magic bytes (as PIL sniffs them), not by its extension."""
    imageio = _imageio()
    if imageio is not None:
        return imageio.imread(path)
    codec = _codec(_head(path))
    if codec is None:
        raise ImportError(
            f"reading {path} needs imageio, which is not installed (the "
            "native decoder, native/libradnerf_io.so, did not load "
            "either); the port's own codecs read PNG and baseline JPEG "
            "only")
    with open(path, "rb") as f:
        return codec[1](f.read())


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file: PIL's where it is installed, else
    the PNG (IHDR) or JPEG (SOFn) header's."""
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as img:
            return img.size
    with open(path, "rb") as f:
        data = f.read()
    codec = _codec(data)
    if codec is None:
        raise ImportError(f"the size of {path} needs PIL, which is not "
                          "installed; the header reader knows PNG and JPEG")
    return codec[2](data)


def _lerp(a: np.ndarray, b: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float32 round(a + (b - a) w) with one rounding of the fused
    multiply-add (b - a is rounded first): cv2's INTER_LINEAR arithmetic
    on float32 images."""
    return ((b - a).astype(np.float64) * w + a).astype(np.float32)


def _linear_taps(n_out: int, n_in: int):
    """Source indices (clamped to the image) and float32 weights of the
    second tap: the half-pixel map (d + 0.5) * scale - 0.5 in float64, as
    cv2 computes it (scale = 1 / (n_out / n_in))."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    s = np.floor(f)
    w = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w


def resize_linear(img: np.ndarray, wh: tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, wh) (INTER_LINEAR) of a float32 (H, W[, C]) image
    without cv2: rows first, then columns, each output the two nearest
    samples' lerp under the half-pixel map, with the edge samples
    repeated outside the image. On [0, 1] images it is within 2^-24 of
    cv2 (tests/test_torch_data.py)."""
    img = np.asarray(img, np.float32)
    w_out, h_out = wh
    x0, x1, wx = _linear_taps(w_out, img.shape[1])
    wx = wx.reshape((-1,) + (1,) * (img.ndim - 2))
    rows = _lerp(img[:, x0], img[:, x1], wx)
    y0, y1, wy = _linear_taps(h_out, img.shape[0])
    return _lerp(rows[y0], rows[y1], wy.reshape((-1,) + (1,) * (img.ndim - 1)))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as PNG: imageio where it is
    installed, else the port's codec."""
    imageio = _imageio()
    if imageio is not None:
        imageio.imwrite(path, img)
    else:
        png.write_png(path, img)


def read_image(
    img_path: str,
    img_wh: tuple[int, int],
    blend_a: bool = True,
    unpad: int = 0,
) -> np.ndarray:
    """Load an image as a flattened (H*W, 3) float array in [0, 1]
    (color_utils.py:21-35): alpha is blended onto white (or premultiplied),
    optional border unpadding, resize to img_wh (cv2 where it is
    installed, else resize_linear)."""
    img = imread(img_path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 4:  # alpha blend (blend A to RGB)
        if blend_a:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        else:
            img = img[..., :3] * img[..., -1:]
    else:
        img = img[..., :3]
    if unpad > 0:
        img = img[unpad:-unpad, unpad:-unpad]
    if (img.shape[1], img.shape[0]) != tuple(img_wh):
        try:
            import cv2
        except ImportError:
            img = resize_linear(img, tuple(img_wh))
        else:
            img = cv2.resize(img, tuple(img_wh))
    return img.reshape(-1, 3)


def read_images_with_decoder(
    paths: list[str],
    img_wh: tuple[int, int],
    blend_a: bool = True,
    unpad: int = 0,
    native: bool = True,
) -> tuple[np.ndarray, str]:
    """Batch image load: the native threaded C++ decoder
    (native/radnerf_io.cpp) when it loads and `native` is set (the
    loaders whose JAX twins call read_images), `read_image` per image
    otherwise. Returns ((n, W*H, 3) float32 in [0, 1], the decoder's
    name)."""
    if native:
        from .native import load_images

        out = load_images(paths, img_wh, blend_a=blend_a, unpad=unpad)
        if out is not None:
            return out, "native"
    rays = np.stack(
        [read_image(p, img_wh, blend_a=blend_a, unpad=unpad) for p in paths]
    ).astype(np.float32)
    return rays, python_decoder(paths[0])


def depth2img(depth: np.ndarray) -> np.ndarray:
    """Turbo-colormapped depth visualization (train.py:48-53), in cv2's
    BGR order as the reference writes it: equal to cv2.applyColorMap(...,
    COLORMAP_TURBO)."""
    depth = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
    return TURBO_RGB[(depth * 255).astype(np.uint8)][..., ::-1].copy()
