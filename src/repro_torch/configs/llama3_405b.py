"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    fsdp=True,  # ZeRO-3 weight sharding over 'data' is mandatory at 405B
    skip_shapes=("long_500k",),
)
