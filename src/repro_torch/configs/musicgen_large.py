"""musicgen-large [audio]: decoder-only LM over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf].
EnCodec frontend is a stub per assignment: input_specs() provides the token
stream (and optionally precomputed conditioning frames).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, mlp_act="gelu", frontend="audio",
)
