"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The conv audio frontend is a STUB per the assignment: input_specs()
supplies precomputed frame embeddings (B, 1500, d_model). Encoder
self-attn + decoder causal/cross attention are real. The decoder is
full-attention → long_500k skipped; decode_32k runs on the decoder KV.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    rope_theta=0.0,  # whisper uses learned/sinusoidal absolute positions
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_frames",
    skip_shapes=("long_500k",),
)
