"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; unverified]

81 layers = 13 super-layers x (6 mamba + 1 shared-attn application) + 3 tail
mamba layers (models/hybrid.py). Sub-quadratic (SSM state decode) → runs
long_500k.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)
