"""Trace reduction (app/metrics.scope_device_times) on a CPU trace."""

import jax
import jax.numpy as jnp

from vkrt_jax.app.metrics import _kernel_key, hlo_scopes, scope_device_times


def test_hlo_scopes_joins_frame_scopes():
    text = '''
  %fusion.3 = f32[8] fusion(%p), metadata={op_name="jit(f)/trace_shadow_d1/group_sort/add"}
  ROOT %while.2 = (s32[]) while(%t), metadata={op_name="jit(f)/trace_closest_d0/while"}
  %copy.1 = f32[8] copy(%p)
  %gather.9 = f32[8] gather(%a, %b), metadata={op_name="jit(f)/sample_d1/gather"}
  %add.4 = f32[8] add(%a, %b), metadata={op_name="jit(f)/add"}
'''
    assert hlo_scopes(text) == {"fusion.3": "trace_shadow_d1/group_sort",
                                "while.2": "trace_closest_d0",
                                "gather.9": "sample_d1", "add.4": "other"}
    assert _kernel_key("loop_fusion.12") == "loop_fusion_12"


def test_hlo_scopes_follow_the_while_op():
    """Two loops running one traced function get cloned condition/body
    computations whose metadata names the first call site; their
    instructions take the scope of the while op that runs them."""
    text = '''
%cond.1 (p: (s32[])) -> pred[] {
  ROOT %input_reduce_fusion.12 = pred[] fusion(%p), metadata={op_name="jit(f)/trace_shadow_d0/while/cond/not"}
}

%cond.1.clone (p: (s32[])) -> pred[] {
  ROOT %input_reduce_fusion.13 = pred[] fusion(%p), metadata={op_name="jit(f)/trace_shadow_d0/while/cond/not"}
}

ENTRY %main.9 (a: s32[]) -> s32[] {
  %while.1 = (s32[]) while(%t), condition=%cond.1, body=%body.1, metadata={op_name="jit(f)/trace_shadow_d0/while"}
  %while.2 = (s32[]) while(%t), condition=%cond.1.clone, body=%body.2, metadata={op_name="jit(f)/trace_shadow_d1/while"}
}
'''
    sc = hlo_scopes(text)
    assert sc["input_reduce_fusion.12"] == "trace_shadow_d0"
    assert sc["input_reduce_fusion.13"] == "trace_shadow_d1"


def test_scope_device_times_on_cpu_trace(tmp_path):
    def f(x):
        with jax.named_scope("trace_closest_d0"):
            y = jnp.sin(x) @ x.T
        with jax.named_scope("sample_d0"):
            return jnp.cumsum(y, axis=0) + y.sum()

    x = jnp.ones((256, 256), jnp.float32)
    compiled = jax.jit(f).lower(x).compile()
    jax.block_until_ready(compiled(x))
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            jax.block_until_ready(compiled(x))
    r = scope_device_times(str(tmp_path), compiled.as_text())
    assert "trace_closest_d0" in r["scopes"]
    assert 0.0 < r["busy_ms"] <= r["window_ms"]
    assert 0.0 <= r["idle_share"] < 1.0
    assert r["top_ops"] and all(len(t) == 3 for t in r["top_ops"])
