"""Models of the port: the functional char-GPT (``gpt``), beam search
(``beam``), speculative decoding (``speculative``), the ring-cache stream
of windowed models (``stream``), int8 decode (``quant``) and LoRA
(``lora``)."""

from .beam import gpt_generate_beam
from .gpt import (GPTConfig, gpt_apply, gpt_decode_chunk, gpt_decode_step,
                  gpt_generate, gpt_loss, gpt_prefill, init_decode_cache,
                  init_gpt_params, sample_token)
from .speculative import (gpt_decode_block, gpt_generate_speculative,
                          gpt_generate_speculative_draft,
                          spec_accept_or_resample)

__all__ = ["GPTConfig", "init_gpt_params", "gpt_apply", "gpt_loss",
           "gpt_prefill", "gpt_decode_step", "gpt_decode_chunk",
           "gpt_generate", "init_decode_cache", "sample_token",
           "gpt_generate_beam", "gpt_decode_block",
           "gpt_generate_speculative", "gpt_generate_speculative_draft",
           "spec_accept_or_resample"]
