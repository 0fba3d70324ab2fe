"""Image IO and color-space helpers (twin of radnerf_tpu/data/color_utils.py).

Images are decoded by the native library (data/native.py) when it loads,
else by imageio, else, for PNGs, by the port's own codec (data/png.py);
each loader records which one read its images. A resize needs cv2. The
turbo colormap of `depth2img` is a copy of cv2's 256-entry table, so it
needs no cv2.
"""

from __future__ import annotations

import numpy as np

from . import png

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


def python_decoder() -> str:
    """The decoder `imread` takes: 'imageio', or the port's 'png codec'."""
    return "imageio" if _imageio() is not None else "png codec"


def imread(path: str) -> np.ndarray:
    """uint8 (H, W) or (H, W, C), as imageio.imread gives it."""
    imageio = _imageio()
    if imageio is not None:
        return imageio.imread(path)
    if path.lower().endswith(".png"):
        return png.read_png(path)
    raise ImportError(
        f"reading {path} needs imageio, which is not installed (the native "
        "decoder, native/libradnerf_io.so, did not load either); the "
        "port's own codec reads PNG only")


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
    optional border unpadding, resize to img_wh (which needs cv2)."""
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
        except ImportError as e:
            raise ImportError(
                f"{img_path} is {img.shape[1]}x{img.shape[0]}, not "
                f"{img_wh[0]}x{img_wh[1]}: resizing needs cv2, which is not "
                "installed (the native decoder, native/libradnerf_io.so, "
                "did not load either)") from e
        img = cv2.resize(img, tuple(img_wh))
    return img.reshape(-1, 3)


def read_images_with_decoder(
    paths: list[str],
    img_wh: tuple[int, int],
    blend_a: bool = True,
    unpad: int = 0,
) -> tuple[np.ndarray, str]:
    """Batch image load: the native threaded C++ decoder
    (native/radnerf_io.cpp) when it loads, `read_image` per image
    otherwise. Returns ((n, W*H, 3) float32 in [0, 1], the decoder's
    name)."""
    from .native import load_images

    out = load_images(paths, img_wh, blend_a=blend_a, unpad=unpad)
    if out is not None:
        return out, "native"
    rays = np.stack(
        [read_image(p, img_wh, blend_a=blend_a, unpad=unpad) for p in paths]
    ).astype(np.float32)
    return rays, python_decoder()


def depth2img(depth: np.ndarray) -> np.ndarray:
    """Turbo-colormapped depth visualization (train.py:48-53), in cv2's
    BGR order as the reference writes it: equal to cv2.applyColorMap(...,
    COLORMAP_TURBO)."""
    depth = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
    return TURBO_RGB[(depth * 255).astype(np.uint8)][..., ::-1].copy()
