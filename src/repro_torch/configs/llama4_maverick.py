"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; 128 routed experts
top-1 + shared expert, MoE on alternate layers; iRoPE-style attention:
chunked-local (8192) RoPE layers with every 4th layer global NoPE.
The upstream card is marked *unverified*; interleaving choices recorded in
DESIGN.md §Config provenance. [vlm] card: backbone only — the vision
frontend is a stub (input_specs feeds precomputed token embeddings).
"""

from repro_torch.models.transformer import LayerSpec, TransformerConfig

from .base import LM_SHAPES, ArchBundle, register

_LOCAL_MOE = LayerSpec(ffn="moe", use_rope=True, chunk=8192)
_LOCAL_DENSE = LayerSpec(ffn="dense", use_rope=True, chunk=8192)
_GLOBAL_DENSE = LayerSpec(ffn="dense", use_rope=False, chunk=None)  # NoPE

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_head=128, d_ff=8192, vocab=202048,
    rope_theta=500_000.0,
    pattern=(_LOCAL_MOE, _LOCAL_DENSE, _LOCAL_MOE, _GLOBAL_DENSE),
    n_experts=128, top_k=1, n_shared=1, d_ff_moe=8192,
    moe_impl="gathered_sort")

SMOKE_CONFIG = TransformerConfig(
    name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
    pattern=(LayerSpec(ffn="moe", chunk=64),
             LayerSpec(ffn="dense", chunk=64),
             LayerSpec(ffn="moe", chunk=64),
             LayerSpec(ffn="dense", use_rope=False)),
    n_experts=4, top_k=1, n_shared=1, d_ff_moe=32, moe_impl="dense")

register(ArchBundle(
    arch_id="llama4-maverick-400b-a17b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    notes="chunked-local attention keeps 3/4 of layers O(S*chunk): the one "
          "assigned LM arch where long prefill is sub-quadratic."))
