"""Serving kimi-k2-1t-a32b (smoke size) against ``repro``: prefill and 24 decode
steps teacher-forced with ``repro``'s greedy tokens, under takum, takum8 and mxt8 (mxt8
weights and KV cache) at f32 activations.
The limits and the routing rule are ``tests/_moe_serve.py``'s.
"""

import pytest

pytest.importorskip("torch")

from _moe_serve import check_serving  # noqa: E402


@pytest.mark.parametrize("policy,act", [("takum", "f32"), ("takum8", "f32"), ("mxt8", "f32")])
def test_prefill_and_decode_match_repro(monkeypatch, policy, act):
    check_serving(monkeypatch, "kimi_k2_1t_a32b", policy, act)
