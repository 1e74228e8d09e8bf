"""qwen1.5-4b  [dense] — MHA (kv == heads) with QKV bias.
[hf:Qwen/Qwen1.5 family; hf]

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        d_ff=6912,
        vocab_size=151936,
        attention="gqa",
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        qkv_bias=True,
        rope_theta=5_000_000.0,
    )
