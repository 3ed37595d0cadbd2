"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed, fine-grained.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # fine-grained expert width
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    skip_shapes=("long_500k",),
)
