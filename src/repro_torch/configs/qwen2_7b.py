"""qwen2-7b [arXiv:2407.10671; hf]: dense GQA LM with QKV bias.

28L d_model=3584 28H (GQA kv=4) d_head=128 d_ff=18944 vocab=152064.
"""

from repro_torch.models.transformer import LayerSpec, TransformerConfig

from .base import LM_SHAPES, ArchBundle, register

CONFIG = TransformerConfig(
    name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_head=128, d_ff=18944, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, pattern=(LayerSpec(),))

SMOKE_CONFIG = TransformerConfig(
    name="qwen2-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, qkv_bias=True, pattern=(LayerSpec(),))

register(ArchBundle(
    arch_id="qwen2-7b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    notes="GQA kv=4, QKV bias; full attention (long_500k is decode-only, "
          "see DESIGN.md LM shape notes)."))
