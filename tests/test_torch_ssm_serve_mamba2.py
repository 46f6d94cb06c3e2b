"""Serving mamba2-780m (smoke size) against ``repro``: prefill and 24
decode steps teacher-forced with ``repro``'s greedy tokens, under takum and
takum8 at f32 and at bf16 activations, the conv tails and SSM states held
after the prefill and after the last step.  The limits are
``tests/_ssm_serve.py``'s.
"""

import pytest

pytest.importorskip("torch")

from _ssm_serve import check_serving  # noqa: E402


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("policy", ["takum", "takum8"])
def test_prefill_and_decode_match_repro(policy, act):
    check_serving("mamba2_780m", policy, act)
