"""NN building blocks of the port, with the JAX package's public names
(``linalg_tpu/nn/__init__.py``): activations with explicit derivatives,
LayerNorm/RMSNorm, positional encodings, attention, the flash kernels'
entry points, tokenizers and KV caches. The stateful classes keep the
reference's forward/backward/step contract (``nn.stateful``)."""

from .activations import (ACTIVATIONS, GATED_ACTIVATIONS, geglu,
                          geglu_backward, gelu, gelu_backward, get_activation,
                          relu, relu_backward, silu, silu_backward, swiglu,
                          swiglu_backward)
from .attention import (MHA, Attention, MultiHeadAttention,
                        ScaledDotProductAttention, causal_mask, he_init,
                        mha_apply, mha_init, softmax_last)
from .cache import (KVCache, LayerKVCache, apply_kv_cache, fkv_advance,
                    fkv_init, fkv_update)
from .flash import flash_attention
from .flash_long import flash_attention_long
from .flash_stream import flash_attention_stream
from .functional import (layer_norm, rms_norm, rope_rotate, sdpa,
                         sinusoidal_encoding)
from .normalization import LayerNorm, RMSNorm, get_norm
from .positional import (LearnedPositionalEmbedding,
                         RotaryPositionalEmbedding, get_positional_encoding)
from .tokenizers import BaseTokenizer, BPETokenizer, CharTokenizer

__all__ = [
    # activations
    "relu", "relu_backward", "gelu", "gelu_backward", "silu",
    "silu_backward", "swiglu", "swiglu_backward", "geglu", "geglu_backward",
    "get_activation", "ACTIVATIONS", "GATED_ACTIVATIONS",
    # normalization
    "LayerNorm", "RMSNorm", "get_norm", "layer_norm", "rms_norm",
    # positional
    "sinusoidal_encoding", "LearnedPositionalEmbedding",
    "RotaryPositionalEmbedding", "get_positional_encoding", "rope_rotate",
    # attention
    "softmax_last", "causal_mask", "ScaledDotProductAttention",
    "MultiHeadAttention", "MHA", "Attention", "he_init", "sdpa",
    "flash_attention", "flash_attention_long", "flash_attention_stream",
    "mha_init", "mha_apply",
    # tokenizers
    "BaseTokenizer", "CharTokenizer", "BPETokenizer",
    # cache
    "KVCache", "LayerKVCache", "apply_kv_cache", "fkv_init", "fkv_update",
    "fkv_advance",
]
