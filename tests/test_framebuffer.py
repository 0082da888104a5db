"""Framebuffer output: the PNG encoder and the golden metrics."""

import io

import numpy as np

from vkrt_jax.app.framebuffer import encode_png, golden_metrics, write_png


def test_png_roundtrip(tmp_path, rng):
    """encode_png writes a PNG any decoder reads back texel-exact (f32
    images are UNORM-quantized, u8 images pass through)."""
    from PIL import Image

    img = rng.uniform(-0.1, 1.1, (13, 7, 3)).astype(np.float32)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    got = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(got, want)
    write_png(str(tmp_path / "f.png"), want)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f.png")), want)


def test_golden_metrics_certified_set(rng):
    a = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
    b = a.copy()
    b[3, 4] += 0.5                      # one flipped pixel
    stable = np.ones((20, 30), bool)
    stable[3, 4] = False
    m = golden_metrics(a, b, stable=stable)
    assert m["rmse_stable"] == 0.0 and m["stable_frac"] < 1.0
    assert m["flip_frac"] == 1 / 600 and m["rmse"] > 0.0
    assert m["rmse_trimmed"] < m["rmse"]
