"""NN building blocks of the port (forward functions, KV cache, tokenizer)."""
