"""Model families: hparams, GGUF weight mapping, the Gemma-3 serve forward."""

from .hparams import HParams, load_hparams
from .weights import LayerWeights, ModelWeights, load_weights
from .gemma import KVCache, forward, init_cache

__all__ = [
    "HParams",
    "load_hparams",
    "LayerWeights",
    "ModelWeights",
    "load_weights",
    "KVCache",
    "forward",
    "init_cache",
]
