"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fsdp=True,  # 35B x (2B param + 4B grad + moments) needs the data axis too
    # 40 full-width KV heads x 64 layers: the bf16 decode_32k cache is
    # 21.5 GB/chip on 256 chips — int8 KV (paper's FXP8) brings it to 10.7
    kv_quant=True,
    skip_shapes=("long_500k",),
)
