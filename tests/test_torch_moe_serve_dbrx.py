"""Serving dbrx-132b (smoke size) against ``repro``: prefill and 24 decode
steps teacher-forced with ``repro``'s greedy tokens, under takum and takum8 at f32
activations and under takum at bf16.
The limits and the routing rule are ``tests/_moe_serve.py``'s.
"""

import pytest

pytest.importorskip("torch")

from _moe_serve import check_serving  # noqa: E402


@pytest.mark.parametrize("policy,act", [("takum", "f32"), ("takum8", "f32"), ("takum", "bf16")])
def test_prefill_and_decode_match_repro(monkeypatch, policy, act):
    check_serving(monkeypatch, "dbrx_132b", policy, act)
