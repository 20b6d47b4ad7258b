"""The LM stack: decoder families (dense, VLM, MoE, SSM, hybrid) and the
whisper-style encoder-decoder, with prefill and cached decode."""
