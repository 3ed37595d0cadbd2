"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,  # 0.5B ties lm_head to the embedding
    rope_theta=1_000_000.0,
    # full attention → no sub-quadratic path for 500k decode
    skip_shapes=("long_500k",),
)
