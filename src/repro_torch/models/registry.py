"""Architecture registry: one exact config per assigned architecture
(``--arch <id>``), plus reduced smoke-test variants.

A copy of ``repro/models/registry.py``'s ``ModelConfig``, ``ARCHS`` and
``reduced`` (the port imports nothing of the reference, whose package
imports JAX); ``tests/test_torch_models.py`` holds the copy equal to
the original field by field.  ``get_family`` / ``get`` resolve every
family: ``encdec`` from ``encdec.py``, the others from ``lm.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

VOCAB_ALIGN = 512      # pad vocab so 16-way model sharding always divides


def _pad_vocab(v: int) -> int:
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                  # dense | moe | mla_moe | xlstm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention
    rope: bool = True
    rope_theta: float = 10000.0
    swa_window: int = 0          # 0 = full attention
    norm_bias: bool = False      # True => LayerNorm, False => RMSNorm
    mlp_act: str = "swiglu"      # swiglu | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    moe_aux_weight: float = 0.01
    # mla (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False
    # ssm (mamba2 / zamba2)
    ssm_expand: int = 2
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 0
    hybrid_every: int = 0
    # xlstm
    xlstm_proj: int = 2
    xlstm_slstm_every: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # frontend stubs
    input_embeds: bool = False   # vlm/audio: precomputed embeddings input
    # which inference shapes apply
    supports_decode: bool = True
    subquadratic: bool = False   # can run long_500k

    @property
    def vocab_pad(self) -> int:
        return _pad_vocab(self.vocab)

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS roofline)."""
        d, l = self.d_model, self.n_layers
        emb = 2 * self.vocab_pad * d
        if self.family == "dense":
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv * self.head_dim * 2
            ff = d * self.d_ff * (3 if self.mlp_act == "swiglu" else 2)
            return emb + l * (attn + ff)
        if self.family == "moe":
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv * self.head_dim * 2
            ff = self.n_experts * d * self.moe_d_ff * 3 + d * self.n_experts
            return emb + l * (attn + ff)
        if self.family == "mla_moe":
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
            moe_l = self.n_layers - self.n_dense_layers
            ff_moe = (self.n_experts + self.n_shared_experts) \
                * d * self.moe_d_ff * 3
            ff_dense = d * self.d_ff * 3
            return emb + self.n_layers * attn + moe_l * ff_moe \
                + self.n_dense_layers * ff_dense
        if self.family == "xlstm":
            di = self.xlstm_proj * d
            pp = di // self.n_heads
            m_per = self.xlstm_slstm_every - 1
            g = l // self.xlstm_slstm_every
            mlstm = d * 2 * di + 3 * self.n_heads * pp * pp + di * d
            slstm = d * 4 * d + 2 * d * int(d * 4 / 3) + int(d * 4 / 3) * d
            return emb + g * (m_per * mlstm + slstm)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            mamba = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) \
                + di * d
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv * self.head_dim * 2
            ff = d * self.d_ff * 3
            return emb + l * mamba + attn + ff
        if self.family == "encdec":
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv * self.head_dim * 2
            ff = d * self.d_ff * 2
            return emb + self.enc_layers * (attn + ff) \
                + self.dec_layers * (2 * attn + ff)
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only)."""
        if self.family == "moe":
            dense_like = dataclasses.replace(
                self, family="dense",
                d_ff=self.moe_d_ff * self.top_k)
            return dense_like.param_count()
        if self.family == "mla_moe":
            total = self.param_count()
            moe_l = self.n_layers - self.n_dense_layers
            ff_moe_all = (self.n_experts + self.n_shared_experts) \
                * self.d_model * self.moe_d_ff * 3 * moe_l
            ff_active = (self.top_k + self.n_shared_experts) \
                * self.d_model * self.moe_d_ff * 3 * moe_l
            return total - ff_moe_all + ff_active
        return self.param_count()


# ---------------------------------------------------------------- the pool
ARCHS: Dict[str, ModelConfig] = {
    "starcoder2-3b": ModelConfig(
        arch="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv=2, head_dim=128, d_ff=12288, vocab=49152,
        rope_theta=1e5, norm_bias=True, mlp_act="gelu"),
    "starcoder2-15b": ModelConfig(
        arch="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv=4, head_dim=128, d_ff=24576, vocab=49152,
        rope_theta=1e5, norm_bias=True, mlp_act="gelu"),
    "deepseek-7b": ModelConfig(
        arch="deepseek-7b", family="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv=32, head_dim=128, d_ff=11008, vocab=102400),
    "h2o-danube-3-4b": ModelConfig(
        arch="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
        n_heads=32, n_kv=8, head_dim=120, d_ff=10240, vocab=32000,
        swa_window=4096, subquadratic=True),
    "pixtral-12b": ModelConfig(
        arch="pixtral-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336, vocab=131072,
        rope_theta=1e6, input_embeds=True),
    "deepseek-v3-671b": ModelConfig(
        arch="deepseek-v3-671b", family="mla_moe", n_layers=61,
        d_model=7168, n_heads=128, n_kv=128, head_dim=128, d_ff=18432,
        vocab=129280, n_experts=256, top_k=8, moe_d_ff=2048,
        n_shared_experts=1, n_dense_layers=3, q_lora_rank=1536,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True),
    "granite-moe-1b-a400m": ModelConfig(
        arch="granite-moe-1b-a400m", family="moe", n_layers=24,
        d_model=1024, n_heads=16, n_kv=8, head_dim=64, d_ff=0, vocab=49155,
        n_experts=32, top_k=8, moe_d_ff=512),
    "xlstm-1.3b": ModelConfig(
        arch="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
        n_heads=4, n_kv=4, head_dim=512, d_ff=0, vocab=50304, rope=False,
        xlstm_proj=2, xlstm_slstm_every=8, subquadratic=True),
    "whisper-tiny": ModelConfig(
        arch="whisper-tiny", family="encdec", n_layers=8, d_model=384,
        n_heads=6, n_kv=6, head_dim=64, d_ff=1536, vocab=51865, rope=False,
        norm_bias=True, mlp_act="gelu", enc_layers=4, dec_layers=4,
        input_embeds=True),
    "zamba2-1.2b": ModelConfig(
        arch="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv=32, head_dim=64, d_ff=8192, vocab=32000,
        ssm_expand=2, ssm_heads=64, ssm_head_dim=64, ssm_state=64,
        hybrid_every=6, subquadratic=True),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Laptop-scale smoke-test variant preserving family structure."""
    common = dict(d_model=64, vocab=512, head_dim=16)
    if cfg.family in ("dense", "moe"):
        return dataclasses.replace(
            cfg, n_layers=2, n_heads=4, n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads),
            d_ff=128 if cfg.d_ff else 0, swa_window=8 if cfg.swa_window else 0,
            n_experts=4 if cfg.n_experts else 0,
            top_k=2 if cfg.top_k else 0,
            moe_d_ff=32 if cfg.moe_d_ff else 0, **common)
    if cfg.family == "mla_moe":
        return dataclasses.replace(
            cfg, n_layers=3, n_dense_layers=1, n_heads=4, n_kv=4,
            d_ff=128, n_experts=4, top_k=2, moe_d_ff=32, q_lora_rank=32,
            kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            **common)
    if cfg.family == "xlstm":
        return dataclasses.replace(
            cfg, n_layers=4, n_heads=2, n_kv=2, xlstm_slstm_every=2,
            d_model=64, vocab=512, head_dim=64)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=4, n_heads=4, n_kv=4, d_ff=128, ssm_heads=4,
            ssm_head_dim=32, ssm_state=16, hybrid_every=2, **common)
    if cfg.family == "encdec":
        return dataclasses.replace(
            cfg, n_layers=4, enc_layers=2, dec_layers=2, n_heads=4, n_kv=4,
            d_ff=128, **common)
    raise ValueError(cfg.family)


def get_family(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "encdec":
        from .encdec import ENCDEC_FAMILY
        return ENCDEC_FAMILY
    from .lm import FAMILIES
    return FAMILIES[cfg.family]


def get(arch: str, smoke: bool = False):
    """Returns (cfg, family-fns dict) for an architecture id."""
    cfg = ARCHS[arch]
    if smoke:
        cfg = reduced(cfg)
    return cfg, get_family(cfg)
