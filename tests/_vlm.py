"""What the vlm tests share: ``repro``'s smoke parameters of
llama-3.2-vision-90b with the cross-attention gates and norm gains redrawn
nonzero (``tanh(0) = 0`` would remove the whole cross path from the
logits, so a wrong cross-attention would pass), and media drawn from
``np.random.default_rng`` as ``tests/test_arch_smoke.py`` draws it."""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.quant.qtensor import QTensor as JQTensor

ARCH = "llama3_2_vision_90b"


def _np(tree_):
    """repro tree -> numpy leaves (copies), QTensors as {bits, fmt, scale},
    NamedTuples (``MambaParams``) kept as such."""
    if isinstance(tree_, dict):
        return {k: _np(v) for k, v in tree_.items()}
    if hasattr(tree_, "_fields"):
        return type(tree_)(*(_np(v) for v in tree_))
    if isinstance(tree_, JQTensor):
        return {"bits": np.asarray(tree_.bits), "fmt": tree_.fmt,
                "scale": None if tree_.scale is None else np.asarray(tree_.scale)}
    return np.array(tree_)


@functools.lru_cache(maxsize=None)
def _jparams(seed: int = 0):
    """``repro``'s smoke parameters (jitted: one compile)."""
    return jax.jit(lambda k: JT.init_params(jconfigs.get_smoke(ARCH), k))(
        jax.random.PRNGKey(seed))


def gated_params(seed: int = 0) -> dict:
    """``repro``'s smoke parameters as numpy, the cross layers' gates and
    norm gains redrawn nonzero (N(0, 1) and N(0, 0.5))."""
    p = _np(_jparams(seed))
    rng = np.random.default_rng(100 + seed)
    cross = p["cross_layers"]
    cross["gate"] = rng.standard_normal(cross["gate"].shape).astype(np.float32)
    cross["ln"] = (0.5 * rng.standard_normal(cross["ln"].shape)).astype(np.float32)
    return p


def _jtree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def media_of(cfg, batch: int, seed: int) -> np.ndarray:
    """f32 [batch, num_media_tokens, media_d] normals from ``default_rng``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.num_media_tokens, cfg.media_d)).astype(np.float32)
