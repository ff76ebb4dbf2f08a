"""AI21-Jamba2-Mini [hybrid] — 32L d4096 32H (GQA kv=8) vocab=65536, as
published: blocks of 8 layers, attention at offset 4 and Mamba-1 elsewhere
(the published mixer: conv1d and dt_proj biases, RMSNorms on dt, B and C;
d_state 16, d_conv 4, expand 2, dt_rank 256 = d_model // 16, the port's
rule), no RoPE; MoE on the odd
layers (16 experts of width 14336, top-2, softmax gates not renormalised),
a SwiGLU of width 14336 on the even ones.

``CONFIG`` is one rank of a 2-way expert-parallel deployment: the router
routes over all 16 experts and this device holds experts 0-7 of each MoE
layer.  Not in ``base._REGISTRY`` (the registry's names are the reference
package's); the benchmark builds the same config from
``portbench/configs/jamba2_mini.json``."""
from repro_torch.configs.base import ArchConfig, MoEConfig

SOURCE = ("https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/"
          "config.json")
SUPERBLOCK = ("m", "m", "m", "m", "a", "m", "m", "m")

CONFIG = ArchConfig(
    name="jamba2_mini", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=65536, rope_theta=0.0,
    superblock=SUPERBLOCK,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=14336,
                  every_k=2, first_k_dense=0, layer_offset=1, held=(0, 8),
                  renorm_topk=False),
    d_state=16, ssm_expand=2, mamba_variant="jamba",
    source=SOURCE,
)

SMOKE = ArchConfig(
    name="jamba2_mini_smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512, rope_theta=0.0,
    superblock=SUPERBLOCK,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=96,
                  every_k=2, first_k_dense=0, layer_offset=1, held=(0, 8),
                  renorm_topk=False),
    d_state=8, ssm_expand=2, mamba_variant="jamba",
    source=SOURCE,
)
