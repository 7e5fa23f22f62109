"""Architecture config schema for the 10 assigned LM architectures (the
port's copy of ``repro.lm.config``)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rms"                # rms | np_ln | ln
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embed: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scale
    logits_softcap: float = 0.0
    # moe
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1               # layer i is MoE iff (i % every == every-1)
    moe_shared: bool = False
    moe_d_ff: int = 0                # expert FFN width (0 -> d_ff)
    moe_scheme: str = "scatter"      # scatter | dense
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssd_chunk: int = 64
    # hybrid (recurrentgemma): mixer pattern, cycled over layers
    mixer_pattern: tuple = ()        # e.g. ("rglru","rglru","local")
    local_window: int = 2048
    d_rnn: int = 0                   # rglru width (0 -> d_model)
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                 # stubbed frontend positions
    # vlm (paligemma)
    prefix_tokens: int = 0           # stubbed image-patch positions
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    kv_quant: bool = False           # int8 decode KV cache (§Perf lever)
    # sharding knobs (see dist/sharding.py)
    moe_shard: str = "ep"            # ep | tp  (grok: 8 experts < 16 -> tp)
    seq_shard_blocks: bool = True    # Megatron-SP between blocks
    shard_profile: str = "tp"        # tp | flat_dp (pure-FSDP, no TP)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def mixer_of(self, i: int) -> str:
        if self.family == "ssm":
            return "ssd"
        if self.mixer_pattern:
            return self.mixer_pattern[i % len(self.mixer_pattern)]
        return "attn"

    def ffn_of(self, i: int) -> str:
        if self.family == "ssm":
            return "none"
        if self.moe_experts and (i % self.moe_every == self.moe_every - 1):
            return "moe"
        return "mlp"

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        n_mats = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = n_mats * d * self.d_ff
        moe_ff = self.moe_d_ff or self.d_ff
        moe = (self.moe_experts * n_mats * d * moe_ff
               + d * self.moe_experts
               + (n_mats * d * moe_ff if self.moe_shared else 0))
        ssd = 0
        if self.family == "ssm":
            di = self.d_inner
            ssd = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d
        rglru = 0
        if "rglru" in (self.mixer_pattern or ()):
            dr = self.d_rnn or self.d_model
            rglru = 2 * d * dr + 2 * dr * dr + dr * d
        emb = self.vocab * d * (1 if self.tie_embed else 2)
        total = emb
        active = emb
        for i in range(self.n_layers):
            mix = {"attn": attn, "local": attn, "ssd": ssd,
                   "rglru": rglru}[self.mixer_of(i)]
            total += mix
            active += mix
            f = self.ffn_of(i)
            if f == "mlp":
                total += mlp
                active += mlp
            elif f == "moe":
                total += moe
                active += (self.moe_top_k * n_mats * d * moe_ff
                           + d * self.moe_experts
                           + (n_mats * d * moe_ff if self.moe_shared else 0))
        if self.enc_layers:  # whisper encoder (+ its own attn/mlp)
            enc = self.enc_layers * (attn + 2 * d * self.d_ff)
            total += enc
            active += enc
        return {"total": total, "active": active}
