"""llama-3.2-vision-90b (smoke size) served against ``repro`` under takum,
takum8, ofp8 and bf16 at f32 activations and under takum at bf16: prefill
and 12 decode steps teacher-forced with ``repro``'s greedy tokens, the
gates nonzero, the limits and the check ``tests/_vlm_serve.py``'s (the mx
policies are ``tests/test_torch_vlm_serve_mx.py``'s).
"""

import pytest

pytest.importorskip("torch")

from _vlm_serve import check_serving  # noqa: E402


@pytest.mark.parametrize("policy,act", [("takum", "f32"), ("takum8", "f32"), ("ofp8", "f32"),
                                        ("bf16", "f32"), ("takum", "bf16")])
def test_prefill_and_decode_match_repro(policy, act):
    check_serving(policy, act)
