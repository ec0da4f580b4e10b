"""Config system for the layer-parallel transformer framework.

Every architecture is described by a `ModelConfig`; the MGRIT layer-parallel
solver by an `MGRITConfig`; an experiment cell (arch x input shape x mesh) by
a `RunConfig`. Configs are plain frozen dataclasses so they are hashable and
usable as jit static arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # d_ff of each expert (may differ from dense d_ff)
    d_ff: int = 0
    router_jitter: float = 0.0
    # load-balancing auxiliary loss weight (Switch-style)
    aux_loss_weight: float = 0.01
    # dispatch group size along the sequence (GShard groups): 0 = whole
    # sequence per group (baseline). Smaller groups shrink the
    # (B,S,E,C) dispatch/combine tensors quadratically (§Perf).
    group_size: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-family state space config."""
    version: int = 1             # 1 = Mamba1 (falcon-mamba), 2 = Mamba2 (zamba2)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    headdim: int = 64            # mamba2 head dim
    dt_rank: int = 0             # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"      # decoder | encoder | encdec | hybrid | ssm
    n_layers: int = 12           # decoder layers for decoder/ssm/hybrid,
                                 # encoder layers for encoder family
    n_dec_layers: int = 0        # only for encdec
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    max_seq_len: int = 4096
    head_dim: int = 0            # 0 -> d_model // n_heads
    # block features
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False          # multimodal rope (qwen2-vl) -- positions stub
    act: str = "silu"            # silu (SwiGLU) | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every
    # `hybrid_attn_every` backbone blocks
    hybrid_attn_every: int = 0
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    dropout: float = 0.0
    dtype: str = "bfloat16"      # compute dtype
    # "float32" baseline; "bfloat16" = mixed precision with fp32 master
    # weights in the optimizer (halves weight-read + FSDP-gather bytes)
    param_dtype: str = "float32"
    # switch to flash-style chunked attention at this sequence length
    # (8192 baseline = dense below 8k, as a vanilla XLA model would run)
    attn_chunk: int = 8192

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + self.n_heads * hd * d
        if self.ssm is not None and self.family == "ssm":
            di = self.ssm.expand * d
            blk = d * (2 * di) + di * d + di * (self.ssm.d_state * 2 + 2) \
                + di * self.ssm.d_conv
            n_blocks = self.n_layers
            total = n_blocks * blk
        elif self.moe is not None:
            ff = self.moe.d_ff or self.d_ff
            moe_mlp = self.moe.num_experts * 3 * d * ff + d * self.moe.num_experts
            total = self.n_layers * (attn + moe_mlp)
        else:
            mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            total = self.n_layers * (attn + mlp)
            if self.family == "encdec":
                total += self.n_dec_layers * (2 * attn + mlp)
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ff = self.moe.d_ff or self.d_ff
        dense = self.param_count() - self.n_layers * self.moe.num_experts * 3 * d * ff
        return dense + self.n_layers * self.moe.top_k * 3 * d * ff


# ---------------------------------------------------------------------------
# MGRIT / layer-parallel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MGRITConfig:
    enabled: bool = True
    cf: int = 4                  # coarsening factor
    levels: int = 2              # L
    fwd_iters: int = 1           # V-cycles for forward solve (0 = serial fwd)
    bwd_iters: int = 1           # V-cycles for adjoint solve (0 = serial bwd)
    n_open: int = 0              # serial buffer layers at the start (App. B)
    n_close: int = 0             # serial buffer layers at the end
    h: float = 1.0               # fine-level time step
    # pad the ParallelNet depth to a multiple of this (layer-parallel degree
    # divisibility); padded steps are exact identity (gate = 0).
    pad_to: int = 0
    # adaptive control (paper 3.2.3)
    check_every: int = 500       # batches between indicator probes
    switch_threshold: float = 1.0
    # how many MGRIT levels keep their chunk axis sharded (1 = level 0
    # only, the paper's layout; 2 also shards the first coarse level's
    # relaxation when divisible — §Perf)
    shard_levels: int = 1


# ---------------------------------------------------------------------------
# Input shapes (the assigned shape suite)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


# ---------------------------------------------------------------------------
# Sharding strategy (logical->physical axis rules)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Maps logical axes to physical mesh axes.

    Logical axes used throughout the codebase:
      batch, layers, heads, kv_heads, mlp, embed, vocab, experts, kv_seq,
      seq, pages
    Values are physical axis names or None (replicated). "data+pod" means the
    product of the two axes.
    """
    batch: Optional[str] = "data"
    layers: Optional[str] = None      # MGRIT chunk axis
    heads: Optional[str] = None       # TP over attention heads
    mlp: Optional[str] = None         # TP over d_ff
    vocab: Optional[str] = "model"    # logits/vocab sharding
    embed: Optional[str] = None
    experts: Optional[str] = None     # expert parallelism
    kv_seq: Optional[str] = None      # KV-cache sequence sharding (long ctx)
    pages: Optional[str] = None       # paged-serving state pools (page axis)
    fsdp: Optional[str] = None        # storage sharding of big weight dims
    # whether gradient reduction across pods uses int8 compression
    compress_grads: bool = False


# ---------------------------------------------------------------------------
# Run config = one experiment cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    # bf16 moments let 300B-class models fit a single pod (EXPERIMENTS §Dry-run)
    moment_dtype: str = "float32"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"     # cosine | linear | constant
    total_steps: int = 10000


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    mgrit: MGRITConfig = MGRITConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    shape: ShapeConfig = SHAPES[0]
    sharding: ShardingConfig = ShardingConfig()
    use_pallas: bool = False
    remat: bool = True           # activation checkpointing in serial path
    # gradient-accumulation microbatches (bounds live MGRIT state memory)
    microbatches: int = 1
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
