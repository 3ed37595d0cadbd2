"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.  [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    skip_shapes=("long_500k",),
)
