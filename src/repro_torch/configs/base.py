"""Architecture + shape configuration schema and registry.

The port of the reference's ``repro/configs/base.py``.  Every assigned
architecture is a ``configs/<id>.py`` exporting ``CONFIG`` (exact
published dims) and ``SMOKE`` (reduced same-family config for CPU tests),
copied as data.  ``ArchConfig.input_specs`` gives the dry run's stand-in
inputs (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0
    d_shared: int = 0          # shared-expert ffn width (0 = n_shared*d_expert)
    every_k: int = 1           # MoE on every k-th layer (jamba: 2)
    first_k_dense: int = 0     # leading dense layers (deepseek-moe: 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    # recurrent / hybrid structure: one superblock, repeated.
    # entries: 'a' attention, 'm' mamba, 'M' mLSTM, 's' sLSTM
    superblock: tuple[str, ...] = ()
    d_state: int = 16
    ssm_expand: int = 2
    # modality frontend stub (vlm patches / audio frames), prepended tokens
    n_frontend_tokens: int = 0
    frontend_dim: int = 0      # 0 -> d_model (pre-projected embeddings)
    n_enc_layers: int = 0      # encoder-decoder only
    quant_mode: str = "none"   # 'none' | 'ternary' (the paper's regime)
    long_context_ok: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 32 (shardable over 16-way model axis)."""
        return ((self.vocab + 31) // 32) * 32

    @property
    def n_superblocks(self) -> int:
        if not self.superblock:
            return 0
        assert self.n_layers % len(self.superblock) == 0, (
            self.name, self.n_layers, len(self.superblock))
        return self.n_layers // len(self.superblock)

    def layer_kind(self, li: int) -> tuple[str, str]:
        """-> (mixer, ffn) for layer li: mixer per superblock pattern; ffn
        'moe'/'dense'/'none' per the MoE interleave rules."""
        mixer = self.superblock[li % len(self.superblock)] if self.superblock else "a"
        if self.d_ff == 0 and self.moe is None:
            ffn = "none"
        elif self.moe is None:
            ffn = "dense"
        elif li < self.moe.first_k_dense:
            ffn = "dense"
        elif (li - self.moe.first_k_dense) % self.moe.every_k == 0:
            ffn = "moe"
        else:
            ffn = "dense"
        return mixer, ffn

    def supports(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k" and not self.long_context_ok:
            return False
        return True

    # -- dry-run inputs ------------------------------------------------------

    def input_specs(self, shape: ShapeConfig,
                    device="meta") -> dict[str, torch.Tensor]:
        """Stand-ins for every model input of this shape, the reference's
        shapes and dtypes: int32 ``tokens`` and ``labels`` (B, S), or
        (B, 1) tokens for decode, and a bf16 ``frontend`` for the VLM and
        encoder-decoder families.  Made with ``torch.empty`` on ``device``:
        the ``meta`` device allocates nothing, and under the caller's
        ``FakeTensorMode`` any device gives fake tensors."""
        b, s = shape.global_batch, shape.seq_len

        def empty(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device=device)

        if shape.kind == "train":
            specs = {"tokens": empty(b, s), "labels": empty(b, s)}
        elif shape.kind == "prefill":
            specs = {"tokens": empty(b, s)}
        else:  # decode: one new token against a seq_len-deep context
            specs = {"tokens": empty(b, 1)}
        if self.n_frontend_tokens and shape.kind != "decode":
            specs["frontend"] = empty(b, self.n_frontend_tokens,
                                      self.frontend_dim or self.d_model,
                                      dtype=torch.bfloat16)
        if self.family == "encdec" and shape.kind != "decode":
            # audio frames replace 'frontend'; the decoder sees tokens
            specs["frontend"] = empty(b, s, self.frontend_dim or self.d_model,
                                      dtype=torch.bfloat16)
        return specs


_REGISTRY: dict[str, str] = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "pscnn-kws": "repro_torch.configs.pscnn_kws",
}


def arch_names() -> list[str]:
    return [n for n in _REGISTRY if n != "pscnn-kws"]


def get_arch(name: str, smoke: bool = False):
    mod = importlib.import_module(_REGISTRY[name])
    return mod.SMOKE if smoke else mod.CONFIG
