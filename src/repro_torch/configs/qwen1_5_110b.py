"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fsdp=True,  # 110B params do not fit replicated over 'model' alone
    skip_shapes=("long_500k",),
)
