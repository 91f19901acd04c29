"""Architecture configs of the port.

``get_config(arch_id)`` returns the full config, ``get_smoke_config`` the
reduced same-family variant the CPU tests use; both equal the JAX
package's field for field.  The port serves the architectures whose layers
it has (global and local attention, RG-LRU, Mamba-1): recurrentgemma-2b,
gemma-2b and falcon-mamba-7b.  The JAX package's other ids raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["recurrentgemma_2b", "gemma_2b", "falcon_mamba_7b"]

# the JAX package's other architectures, and why the port lacks them
_NOT_PORTED = {
    "grok_1_314b": "MoE layers (ROADMAP queue 1, item 10)",
    "deepseek_v2_236b": "MLA and MoE layers (ROADMAP queue 1, item 10)",
    "musicgen_large": "multi-codebook audio heads (ROADMAP queue 1, item 10)",
    "qwen1_5_32b": "this config (ROADMAP queue 1, item 10)",
    "chameleon_34b": "this config (ROADMAP queue 1, item 10)",
    "granite_3_8b": "this config (ROADMAP queue 1, item 10)",
    "gemma_7b": "this config (ROADMAP queue 1, item 10)",
    "paper_mnist": "the paper's MLP, which the federation runs "
                   "(repro_torch.core.mlp)",
}


def _module(arch_id: str):
    name = arch_id.replace("-", "_").replace(".", "_")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: the port does not have {_NOT_PORTED[name]} yet")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; the port has "
                       f"{[i.replace('_', '-') for i in ARCH_IDS]}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE
