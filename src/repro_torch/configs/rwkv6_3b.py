"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]

Attention-free linear recurrence → O(1) state decode, runs long_500k.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / 64 time-mix heads (HEAD_DIM=64 in models/rwkv6.py)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    rope_theta=0.0,  # no RoPE — token-shift + decay carries position
)
