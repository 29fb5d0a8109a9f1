"""Models of the port: the functional char-GPT (``gpt``), beam search
(``beam``), speculative decoding (``speculative``), the ring-cache stream
of windowed models (``stream``), int8 decode (``quant``), LoRA
(``lora``), the routed mixture-of-experts GPT (``moe``), and the L2
component stack: the encoder-decoder classes (``transformer``), the
stateful GPT blocks (``gpt_modules``) and the functional seq2seq
(``seq2seq``)."""

from .beam import gpt_generate_beam
from .gpt import (GPTConfig, gpt_apply, gpt_decode_chunk, gpt_decode_step,
                  gpt_generate, gpt_loss, gpt_prefill, init_decode_cache,
                  init_gpt_params, sample_token)
from .gpt_modules import GPT, AdamW, DecoderOnlyLayer
from .moe import (MoEGPTConfig, init_moe_params, moe_ffn, moe_gpt_apply,
                  moe_gpt_loss)
from .seq2seq import (Seq2SeqConfig, init_seq2seq_params, make_reverse_batch,
                      seq2seq_apply, seq2seq_loss)
from .speculative import (gpt_decode_block, gpt_generate_speculative,
                          gpt_generate_speculative_draft,
                          spec_accept_or_resample)
from .transformer import (FFN, Decoder, DecoderLayer, Encoder, EncoderLayer,
                          OutputHead, TokenEmbedding, Transformer,
                          sinusoidal_pos_encoding, softmax_rows)

__all__ = ["GPTConfig", "init_gpt_params", "gpt_apply", "gpt_loss",
           "gpt_prefill", "gpt_decode_step", "gpt_decode_chunk",
           "gpt_generate", "init_decode_cache", "sample_token",
           "gpt_generate_beam", "gpt_decode_block",
           "gpt_generate_speculative", "gpt_generate_speculative_draft",
           "spec_accept_or_resample", "MoEGPTConfig", "init_moe_params",
           "moe_ffn", "moe_gpt_apply", "moe_gpt_loss", "DecoderOnlyLayer",
           "GPT", "AdamW", "FFN", "EncoderLayer", "DecoderLayer", "Encoder",
           "Decoder", "Transformer", "TokenEmbedding", "OutputHead",
           "softmax_rows", "sinusoidal_pos_encoding", "Seq2SeqConfig",
           "init_seq2seq_params", "seq2seq_apply", "seq2seq_loss",
           "make_reverse_batch"]
