"""The port's JPEG codec (radnerf_tpu_torch/data/jpeg.py) against PIL,
whose decoder is libjpeg-turbo's default (the ISLOW IDCT, fancy
upsampling, jdcolor.c's YCbCr tables), as imageio's is: bit-equal
decodes of PIL-written baseline files at qualities 50/75/95, 4:4:4,
4:2:2 and 4:2:0 and gray, at odd sizes, with restart markers and with
optimized Huffman tables; files it cannot read raise; PIL decodes the
codec's own files as the codec does."""

import io

import numpy as np
import pytest

from radnerf_tpu_torch.data import jpeg

Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (3, 5), (8, 8), (17, 23), (33, 2), (2, 33), (31, 47),
         (64, 48)]


def _image(h, w, c=3, seed=0):
    """A smooth pattern with noise: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
    return img.astype(np.uint8)[..., 0] if c == 1 else img.astype(np.uint8)


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [0, 3])
def test_decode_equals_pil(quality, subsampling, restart):
    n_restarts = 0
    for i, (h, w) in enumerate(SIZES):
        kw = dict(quality=quality, subsampling=subsampling)
        if restart:
            kw["restart_marker_blocks"] = restart
        data = _pil_bytes(_image(h, w, seed=i), **kw)
        n_restarts += data.count(b"\xff\xd0")
        got = jpeg.decode_jpeg(data)
        want = _pil_decode(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
    assert (n_restarts > 0) == bool(restart)


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_gray_and_optimized_tables_equal_pil(quality):
    for i, (h, w) in enumerate(SIZES):
        for kw in (dict(quality=quality),
                   dict(quality=quality, optimize=True,
                        restart_marker_rows=1)):
            data = _pil_bytes(_image(h, w, c=1, seed=i), **kw)
            got = jpeg.decode_jpeg(data)
            assert got.shape == (h, w)
            np.testing.assert_array_equal(got, _pil_decode(data))
        data = _pil_bytes(_image(h, w, seed=i), quality=quality,
                          optimize=True, subsampling=2)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                      _pil_decode(data))


def test_decode_a_scene_sized_image_equals_pil():
    """968x1296 4:2:0 at quality 90, the size of a ScanNet frame."""
    data = _pil_bytes(_image(968, 1296, seed=3), quality=90, subsampling=2)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_decode(data))
    assert jpeg.jpeg_size(data) == (1296, 968)


def test_unsupported_files_raise():
    img = _image(16, 16)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(_pil_bytes(img, progressive=True))
    data = bytearray(_pil_bytes(img))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9                        # arithmetic-coded SOF
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(data))
    data[sof + 1] = 0xC1
    data[sof + 4] = 12                          # 12-bit precision
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("quality", [50, 90])
def test_encoded_files_decode_in_pil_as_in_the_codec(subsampling, quality):
    for i, (h, w) in enumerate(SIZES):
        img = _image(h, w, seed=i)
        data = jpeg.encode_jpeg(img, quality, subsampling)
        pil = Image.open(io.BytesIO(data))
        assert pil.format == "JPEG" and pil.size == (w, h)
        want = np.asarray(pil.convert("RGB"))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        # a lossy copy of the image: the mean error is a few levels
        err = np.abs(want.astype(int) - img.astype(int)).mean()
        assert err < 20, err
    gray = _image(21, 30, c=1)
    data = jpeg.encode_jpeg(gray, quality)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_decode(data))


def test_quality_tables_are_libjpegs():
    """jpeg_set_quality's scaling, as PIL (libjpeg) writes it (PIL lists
    the tables in natural order)."""
    for q in (10, 50, 75, 95, 100):
        luma, chroma = jpeg.quality_tables(q)
        pil = Image.open(io.BytesIO(_pil_bytes(_image(8, 8), quality=q)))
        np.testing.assert_array_equal(np.asarray(pil.quantization[0]), luma)
        np.testing.assert_array_equal(np.asarray(pil.quantization[1]),
                                      chroma)
