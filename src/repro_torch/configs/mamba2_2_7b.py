"""mamba2-2.7b [ssm]: 64L d_model=2560 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*2560 = 5120, headdim=64 => 80 SSD heads, ngroups=1, conv width 4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, ssm_conv=4,
    tie_embeddings=True,
)
