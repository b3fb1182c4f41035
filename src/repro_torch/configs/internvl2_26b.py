"""internvl2-26b [vlm]: InternViT frontend (STUB per assignment) + InternLM2-20B
backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, frontend="vision", frontend_tokens=256,
)
