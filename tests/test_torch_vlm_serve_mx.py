"""llama-3.2-vision-90b (smoke size) served against ``repro`` under the mx
policies (mxfp8: bf16 weights and an mxe4m3 KV cache; mxt8 weights and
KV cache) at f32 activations (``tests/_vlm_serve.py``'s check and limits);
the decode step's media; ``load_params`` over the cross layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import step as dstep  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.quant.qtensor import QTensor  # noqa: E402

from _vlm import _np, gated_params, media_of  # noqa: E402
from _vlm_serve import B, S0, _cfgs, _qparams, check_serving  # noqa: E402


@pytest.mark.parametrize("policy,act", [("mxfp8", "f32"), ("mxt8", "f32")])
def test_prefill_and_decode_match_repro(policy, act):
    check_serving(policy, act)


def test_decode_step_reads_the_media_it_is_given():
    """The decode step projects the media it is given (no state kept from
    the prefill): other media move the step's logits, and none raises."""
    _, tcfg = _cfgs("takum", "f32")
    tparams = serve.load_params(convert.params_from_numpy(_np(_qparams("takum")), tcfg,
                                                          device="cpu"))
    prompt = torch.arange(2 * S0).view(B, S0) % tcfg.vocab_size
    m1, m2 = (torch.from_numpy(media_of(tcfg, B, s)) for s in (1, 2))
    logits, cache = serve.make_prefill_step(tcfg, cache_len=S0 + 2)(
        tparams, {"tokens": prompt, "media": m1})
    tok = logits.argmax(-1)
    step = serve.make_serve_step(tcfg)
    a, _ = step(tparams, {"token": tok, "media": m1}, cache)
    cache.pos -= 1  # the same slot again
    b, _ = step(tparams, {"token": tok, "media": m2}, cache)
    cache.pos -= 1
    a2, _ = step(tparams, {"token": tok, "media": m1}, cache)
    assert torch.equal(a, a2) and (a - b).abs().max() > 1e-2 * a.abs().max()
    with pytest.raises(ValueError, match="media"):
        step(tparams, {"token": tok}, cache)


def test_load_params_decodes_the_cross_gains():
    """``load_params`` decodes the packed cross-layer gains once (K1 on the
    card), equal to ``repro``'s dequantized leaf; the gates stay f32 (1-D:
    never packed); the port's own packing equals ``repro``'s bit for bit."""
    jcfg, tcfg = _cfgs("takum", "f32")
    q = _qparams("takum")
    port = convert.params_from_numpy(_np(q), tcfg, device="cpu")
    loaded = serve.load_params(port)
    want = dstep.dequantize_params(q)["cross_layers"]
    assert isinstance(port["cross_layers"]["ln"], QTensor)
    assert np.array_equal(loaded["cross_layers"]["ln"].numpy(), np.asarray(want["ln"]))
    assert port["cross_layers"]["gate"].dtype == torch.float32
    for k in ("wq", "wk", "wv", "wo"):
        assert loaded["cross_layers"][k] is port["cross_layers"][k]
    assert isinstance(loaded["media_proj"], QTensor)
    mine = serve.quantize_params(tcfg, convert.params_from_numpy(gated_params(), tcfg,
                                                                 device="cpu"))
    for k in ("wq", "wk", "wv", "wo", "ln"):
        assert np.array_equal(mine["cross_layers"][k].bits.numpy(),
                              np.asarray(q["cross_layers"][k].bits))
    assert np.array_equal(mine["media_proj"].bits.numpy(), np.asarray(q["media_proj"].bits))
