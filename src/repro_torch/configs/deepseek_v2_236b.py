"""deepseek-v2-236b [arXiv:2405.04434; hf]: MLA + fine-grained MoE.

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), vocab=102400; MoE: 2 shared + 160 routed top-6,
expert d_ff=1536; layer 0 dense (d_ff=12288).
"""

from repro_torch.models.transformer import LayerSpec, TransformerConfig

from .base import LM_SHAPES, ArchBundle, register

CONFIG = TransformerConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_head=128, d_ff=12288, vocab=102400,
    rope_theta=10_000.0,
    prefix=(LayerSpec(ffn="dense"),),
    pattern=(LayerSpec(ffn="moe"),),
    n_experts=160, top_k=6, n_shared=2, d_ff_moe=1536,
    moe_impl="gathered_sort",
    mla=True, q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-v2-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
    prefix=(LayerSpec(ffn="dense"),), pattern=(LayerSpec(ffn="moe"),),
    n_experts=8, top_k=2, n_shared=1, d_ff_moe=32, moe_impl="dense",
    mla=True, q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)

register(ArchBundle(
    arch_id="deepseek-v2-236b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    notes="MLA decode caches the 512-dim latent + 64-dim rope key per "
          "token (vs 128 heads * 256: ~57x KV compression); MoE experts "
          "shard over the model axis."))
