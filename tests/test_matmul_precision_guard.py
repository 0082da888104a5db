"""Guard against reduced-precision matmuls in device code.

On the GPU a float32 `jnp.einsum`, `@`, `jnp.dot` or `lax.dot_general`
with default precision may run in TF32 on the tensor cores, which keeps
about three decimal digits: a device-only wrongness that every CPU test
passes (an attribute or vertex transform rounded this way moves hits and
shading across broad image regions). The device path has no matrix
product: small transforms go through explicit f32 elementwise math
(utils.layout.mat_rows3).

This test greps the package for new matmul sites so a reviewer must
either use mat_rows3 / an explicit precision, or extend the allowlist
CONSCIOUSLY. Host-side numpy code (golden/, app/camera.py,
utils/mathutils.py, scene/, native/) is exempt — numpy matmuls are exact
f32.
"""

import re
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "vkrt_jax"

# device-code files where a matmul-ish pattern is EXPECTED, with the
# required guard on the same statement
ALLOWED: dict = {}

# host-side numpy modules (never traced/jitted)
HOST_ONLY = {"golden", "app/camera.py", "utils/mathutils.py",
             "scene", "native"}

PATTERNS = [
    (re.compile(r"\bjnp\.einsum\s*\("), "jnp.einsum"),
    (re.compile(r"\bjnp\.(dot|matmul|tensordot)\s*\("), "jnp.dot/matmul"),
    (re.compile(r"\bjax\.lax\.dot(_general)?\s*\("), "lax.dot_general"),
    # Pallas in-kernel matmul (same default precision)
    (re.compile(r"\bpl\.dot\s*\("), "pl.dot"),
    # `x @ y` matmul operator (exclude decorators and comment mentions)
    (re.compile(r"^[^#@]*\S\s@\s"), "@ operator"),
]


def _host_only(rel: str) -> bool:
    return any(rel == h or rel.startswith(h + "/") for h in HOST_ONLY)


def test_no_unguarded_device_matmuls():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if _host_only(rel):
            continue
        text = path.read_text()
        lines = text.splitlines()
        for i, line in enumerate(lines):
            stripped = line.split("#", 1)[0]
            if not stripped.strip():
                continue
            for pat, name in PATTERNS:
                if not pat.search(stripped):
                    continue
                allowed = any(tok in stripped
                              for tok in ALLOWED.get(rel, []))
                # a precision=... argument within the next 6 lines of the
                # call counts as guarded
                ctx = "\n".join(lines[i:i + 6])
                guarded = ("precision=" in ctx
                           or "mat_rows3" in stripped)
                if not (allowed or guarded):
                    offenders.append(f"{rel}:{i + 1}: {name}: "
                                     f"{line.strip()[:90]}")
    assert not offenders, (
        "unguarded matmul-class ops in device code (TF32 by default on "
        "the GPU — use utils.layout.mat_rows3 or precision=HIGHEST, or "
        "extend the allowlist consciously):\n" + "\n".join(offenders))
