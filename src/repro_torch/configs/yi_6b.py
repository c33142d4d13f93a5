"""yi-6b [arXiv:2403.04652; hf]: llama-arch GQA LM.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.transformer import LayerSpec, TransformerConfig

from .base import LM_SHAPES, ArchBundle, register

CONFIG = TransformerConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_head=128, d_ff=11008, vocab=64000, qkv_bias=False,
    rope_theta=5_000_000.0, pattern=(LayerSpec(),))

SMOKE_CONFIG = TransformerConfig(
    name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, pattern=(LayerSpec(),))

register(ArchBundle(
    arch_id="yi-6b", family="lm", config=CONFIG, smoke_config=SMOKE_CONFIG,
    shapes=LM_SHAPES,
    notes="llama-style GQA kv=4, no bias."))
