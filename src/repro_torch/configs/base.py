"""Architecture configs of the PyTorch port (its own copy of
``repro.configs.base``, of what the ported model families need).

One ``ArchConfig`` per architecture lives in ``configs/<id>.py`` with the
exact published numbers (the JAX package's ten); ``reduced()`` derives the
CPU smoke-test variant of the same family. ``register``/``get_config`` back
the ``--arch`` selector of ``launch/serve.py``; ``get_config`` refuses an
unknown name. ``SHAPES`` is the assigned input-shape grid (shared by every
LM family) and ``LONG_CONTEXT_OK`` the archs allowed its ``long_500k``.
"""
from __future__ import annotations

import dataclasses
import importlib

_REGISTRY: dict[str, "ArchConfig"] = {}

# Assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: windowed or local / global
# attention, or state-space layers.
LONG_CONTEXT_OK = {"gemma2-27b", "mixtral-8x22b", "mixtral-8x7b",
                   "zamba2-2.7b", "falcon-mamba-7b"}

ARCH_IDS = [
    "qwen2_5_32b", "minitron_4b", "granite_20b", "gemma2_27b",
    "mixtral_8x22b", "mixtral_8x7b", "zamba2_2_7b", "whisper_base",
    "falcon_mamba_7b", "paligemma_3b",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Q heads are padded up to a multiple of this (the JAX package shards
    # heads on a 16-way model axis); the padded heads' rows of wo are zero,
    # so the function is the same.
    head_pad_multiple: int = 1
    # attention features
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 0  # >0: all attention layers windowed
    local_global_alternate: bool = False  # alternate local / global layers
    post_norm: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_version: int = 1
    ssm_chunk: int = 256
    dt_rank: int = 0  # mamba1 low-rank dt; 0 -> ceil(d_model / 16)
    hybrid_attn_every: int = 0
    n_enc_layers: int = 0
    enc_ctx: int = 0
    n_img_tokens: int = 0
    # misc
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu | relu2
    scale_embed: bool = False
    tie_embeddings: bool = False
    remat: bool = True
    unroll_layers: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        """Q-head count after padding (>= n_heads, a multiple of both the pad
        multiple and the kv group size)."""
        m = max(self.head_pad_multiple, 1)
        h = -(-self.n_heads // m) * m
        if self.n_kv_heads > 0:
            while h % self.n_kv_heads:
                h += 1
        return h

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def shapes(self) -> dict[str, tuple[int, int, str]]:
        """The assigned (shape name -> spec) cells of this arch: ``SHAPES``
        without ``long_500k`` outside ``LONG_CONTEXT_OK``."""
        out = dict(SHAPES)
        if self.name not in LONG_CONTEXT_OK:
            out.pop("long_500k", None)
        return out

    def n_params(self) -> int:
        """Approximate total parameter count."""
        d, ff, v, n_layers = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + self.n_heads * hd * d
        mlp = 3 * d * ff if self.act in ("silu", "gelu") else 2 * d * ff
        if self.family == "moe":
            mlp = mlp * self.n_experts + d * self.n_experts
        per_layer = attn + mlp
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            per_layer = 2 * d * di + di * self.ssm_conv + \
                di * (self.resolved_dt_rank + 2 * n) + self.resolved_dt_rank * di + di * d
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            per_layer = d * (2 * di + 2 * n + heads) + di * self.ssm_conv + di * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = n_layers * per_layer + emb
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += (d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                      + self.n_heads * hd * d + 3 * d * self.d_ff)
        if self.family == "encdec":
            total += self.n_enc_layers * (2 * attn + mlp)
        return int(total)

    def n_active_params(self) -> int:
        """Parameters a token uses (= n_params outside MoE)."""
        if self.family != "moe":
            return self.n_params()
        d, ff, n_layers = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + self.n_heads * hd * d
        mlp = 3 * d * ff * self.n_experts_per_tok + d * self.n_experts
        return int(n_layers * (attn + mlp) + self.vocab_size * d * 2)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    if not _REGISTRY:
        for mod in ARCH_IDS:
            importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    """Look up an architecture by its public id (e.g. 'qwen2.5-32b')."""
    key = name.replace(".", "_").replace("-", "_")
    _load_all()
    for cfg in _REGISTRY.values():
        if cfg.name == name or cfg.name.replace(".", "_").replace("-", "_") == key:
            return cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def all_configs() -> dict[str, ArchConfig]:
    _load_all()
    return dict(_REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test-size variant of the same family (CPU, float32 compute)."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("hybrid",) else 2),
        d_model=64,
        n_heads=4,
        head_pad_multiple=1,
        n_kv_heads=min(max(cfg.n_kv_heads, 1), 2),
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        n_experts=min(cfg.n_experts, 4),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        dt_rank=8 if cfg.family == "ssm" else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        hybrid_attn_every=min(cfg.hybrid_attn_every, 2) if cfg.hybrid_attn_every else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_ctx=min(cfg.enc_ctx, 16) if cfg.enc_ctx else 0,
        n_img_tokens=min(cfg.n_img_tokens, 4) if cfg.n_img_tokens else 0,
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
