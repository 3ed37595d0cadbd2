"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B, n_patches, d_model) that are prepended to
the token embeddings (anyres: base 576 patches + up to 4 tiles x 576 →
we provision 2880 patch slots).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    frontend="patches",
    n_patches=2880,  # anyres: (1 base + 4 tiles) x 24x24 patches
    fsdp=True,
    skip_shapes=("long_500k",),
)
