"""CLI argument handling (the main.cpp analogue's contract)."""

from vkrt_jax.app.cli import build_parser, resolve_config


def test_config_selection():
    p = build_parser()
    args = p.parse_args(["--config", "3"])
    cfg = resolve_config(args)
    assert (cfg.width, cfg.height) == (1280, 720)
    assert cfg.max_depth == 2 and cfg.enable_reflections


def test_overrides():
    p = build_parser()
    args = p.parse_args(["--config", "1", "--width", "320", "--height", "240",
                         "--lights", "2", "--no-shadows"])
    cfg = resolve_config(args)
    assert (cfg.width, cfg.height) == (320, 240)
    assert cfg.num_lights == 2
    assert not cfg.enable_shadows


def test_default_is_reference_workload():
    p = build_parser()
    cfg = resolve_config(p.parse_args([]))
    assert (cfg.width, cfg.height) == (1600, 1200)   # ref: src/Utils.hpp:32-33
    assert cfg.max_depth == 2 and cfg.num_lights == 4


def test_raster_flags():
    p = build_parser()
    args = p.parse_args(["--raster", "--msaa", "1"])
    assert args.raster and args.msaa == 1


def test_cli_flythrough_pipelined(tmp_path):
    """End-to-end CLI fly-through exercises the frames-in-flight path
    (runtime.FrameScheduler — the 3-swapchain-image analogue, ref:
    src/Context.cpp:141-180) and must match a synchronous render of the
    same final camera exactly."""
    import numpy as np
    from PIL import Image

    from conftest import TEXDIM

    from vkrt_jax.app import cli
    from vkrt_jax.app.flythrough import camera_path
    from vkrt_jax.wavefront.engine import Renderer
    from vkrt_jax import config as C
    import dataclasses

    out = tmp_path / "fly.png"
    rc = cli.main(["--config", "1", "--width", "64", "--height", "48",
                   "--frames", "3", "--max-texture-dim", str(TEXDIM),
                   "--output", str(out)])
    assert rc == 0 and out.exists()
    png = np.asarray(Image.open(out))

    cfg = dataclasses.replace(C.BASELINE_CONFIGS[1](), width=64, height=48)
    cams = list(camera_path(64, 48))
    r = Renderer(cli.DEFAULT_SCENE, cfg, max_texture_dim=TEXDIM,
                 quantize=True)
    fb, _ = r.render(cams[2])      # the last pipelined frame
    np.testing.assert_array_equal(png, fb)


def test_shard_beyond_visible_devices_is_an_error():
    """--shard N with fewer devices visible fails and names them (no
    silent re-exec onto a virtual CPU mesh)."""
    import jax
    import pytest

    from vkrt_jax.app.cli import _shard_devices
    n = len(jax.devices())
    assert len(_shard_devices(2)) == 2 and len(_shard_devices(-1)) == n
    with pytest.raises(SystemExit, match=f"only {n} device"):
        _shard_devices(n + 1)
