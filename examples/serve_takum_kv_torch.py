"""Serving example on the PyTorch/CUDA port: batched decode with a
takum8-packed KV cache (twin of examples/serve_takum_kv.py).

    PYTHONPATH=src python examples/serve_takum_kv_torch.py --device cuda
    PYTHONPATH=src python examples/serve_takum_kv_torch.py --device cpu
    PYTHONPATH=src python examples/serve_takum_kv_torch.py --policy mxfp8
    PYTHONPATH=src python examples/serve_takum_kv_torch.py --policy takum8
    PYTHONPATH=src python examples/serve_takum_kv_torch.py --arch llama3_2_vision_90b

Prefills a prompt batch, then decodes tokens against the packed cache,
reporting cache bytes and the greedy-token agreement with a bf16 cache.
``--policy`` serves a named policy instead (its weights and KV cache, e.g.
``mxfp8``: bf16 weights, an MX-e4m3 cache; ``takum8``: t8 weights and
cache, every kernel through its table codec).  ``--arch`` serves another
arch's smoke config (default llama3_8b); a vlm (llama3_2_vision_90b) gets
a batch of stub media embeddings, drawn once and passed to the prefill
and every decode step, and its cross-attention gates drawn nonzero (they
start at zero, which would take the media out of the logits).  On the
card every cache append is K2 and every decode-step attention is K6.
"""

import argparse
import dataclasses

import torch

from repro_torch import configs, serve
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES, QuantPolicy


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="named policy to serve (default: bf16 weights, takum8 KV cache)")
    ap.add_argument("--arch", default="llama3_8b", help="arch whose smoke config to serve")
    args = ap.parse_args()

    quant = POLICIES[args.policy] if args.policy else QuantPolicy(kv_cache="t8")
    name = args.policy or "takum8"
    cfg8 = configs.get_smoke(args.arch).with_(quant=dataclasses.replace(quant, activations="f32"))
    cfgb = cfg8.with_(quant=dataclasses.replace(cfg8.quant, kv_cache="bf16"))
    params = T.init_params(cfg8, seed=0, device=args.device)
    dev = params["embed"].device
    media = None
    if cfg8.family == "vlm":
        gen = torch.Generator(device=dev).manual_seed(1)
        gate = params["cross_layers"]["gate"]
        gate.copy_(torch.randn(gate.shape, generator=gen, device=dev))
        media = torch.randn((4, cfg8.num_media_tokens, cfg8.media_d), generator=gen, device=dev)
    if args.policy:  # pack the weights as the policy says
        params = serve.load_params(serve.quantize_params(cfg8, params))

    B, S0, STEPS = 4, 16, 24
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg8.vocab_size, (B, S0), generator=gen, device=dev)

    outs = {}
    for label, cfg in [(name, cfg8), ("bf16", cfgb)]:
        logits, cache = T.prefill(cfg, params, prompt, media, cache_len=S0 + STEPS)
        toks = []
        tok = torch.argmax(logits, -1)
        for _ in range(STEPS):
            logits, cache = T.decode_step(cfg, params, tok, cache, media)
            tok = torch.argmax(logits, -1)
            toks.append(tok)
        outs[label] = torch.stack(toks, 1)
        kv_bytes = 2 * cache.k.numel() * cache.k.element_size()
        print(f"{label:7s}: KV cache {kv_bytes / 1024:.0f} KiB ({cfg.quant.kv_cache}, "
              f"{cache.k.dtype}), sample: {outs[label][0][:10].tolist()}")

    agree = (outs[name] == outs["bf16"]).float().mean().item()
    print(f"greedy-token agreement {name} vs bf16 cache: {agree:.2f}  (device: {dev})")


if __name__ == "__main__":
    main()
