"""Serving hymba-1.5b (smoke size) against ``repro``: prefill and 24
decode steps teacher-forced with ``repro``'s greedy tokens, under takum and
takum8 at f32 and at bf16 activations and under mxt8 at f32 (K2-mx and
K6-mx on the attention branch), a prompt past the 16-key window, the conv
tails and SSM states held after the prefill and after the last step.  The
limits are ``tests/_ssm_serve.py``'s.
"""

import pytest

pytest.importorskip("torch")

from _ssm_serve import check_serving  # noqa: E402


@pytest.mark.parametrize("policy,act", [("takum", "f32"), ("takum8", "f32"), ("takum", "bf16"),
                                        ("takum8", "bf16"), ("mxt8", "f32")])
def test_prefill_and_decode_match_repro(policy, act):
    check_serving("hymba_1_5b", policy, act)
