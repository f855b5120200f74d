"""Architecture registry: --arch <id> resolves here (one module per arch;
the data of the JAX package's `configs/`, copied)."""
from importlib import import_module

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gemma-2b": "gemma_2b",
    "qwen3-8b": "qwen3_8b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-32b": "qwen15_32b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-370m": "mamba2_370m",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; choose from {ARCHS}")
    return import_module(f".{_MODULES[name]}", __name__).CONFIG


def all_configs():
    return {name: get_config(name) for name in ARCHS}
