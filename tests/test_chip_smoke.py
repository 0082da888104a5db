"""chip_smoke.py's contract that the CPU can check: it refuses a CPU
device, and --multi runs its phase alone."""

import json

import pytest

import chip_smoke


def test_refuses_cpu_device(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_multi_runs_only_its_phase(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda: ["card"])
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "Card, 1 W")
    monkeypatch.setattr(chip_smoke, "device_record",
                        lambda: {"platform": "gpu", "kind": "k", "count": 4})
    for name in ("phase_multi", "phase_frames", "phase_trace", "phase_lbvh",
                 "phase_golden", "phase_config5", "phase_raster"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    chip_smoke.main(["--multi"])
    assert calls == ["phase_multi"]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "Card, 1 W"
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "k", "count": 4}}
