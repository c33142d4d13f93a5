"""qwen1.5-32b [hf:Qwen/Qwen1.5-*; hf]: dense MHA LM with QKV bias.

64L d_model=5120 40H (kv=40: full MHA) d_ff=27392 vocab=152064.
"""

from repro_torch.models.transformer import LayerSpec, TransformerConfig

from .base import LM_SHAPES, ArchBundle, register

CONFIG = TransformerConfig(
    name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_head=128, d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, pattern=(LayerSpec(),))

SMOKE_CONFIG = TransformerConfig(
    name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, qkv_bias=True, pattern=(LayerSpec(),))

register(ArchBundle(
    arch_id="qwen1.5-32b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    notes="full MHA (kv=40): the decode shapes are KV-bandwidth bound — "
          "the arch most exposed to the memory roofline term."))
