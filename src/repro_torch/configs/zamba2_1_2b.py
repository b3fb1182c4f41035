"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d_model=2048 + ONE shared attention
block (32H kv=32, d_ff=8192) applied every 6th layer, vocab=32000,
ssm_state=64 [arXiv:2411.15242; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, ssm_conv=4,
    attn_every=6, tie_embeddings=True,
)
