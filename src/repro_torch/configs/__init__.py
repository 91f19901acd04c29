"""Architecture configs of the port.

``get_config(arch_id)`` returns the full config, ``get_smoke_config`` the
reduced same-family variant the CPU tests use; both equal the JAX
package's field for field.  The port serves all ten of the JAX package's
architectures: dense (gemma-2b, gemma-7b, granite-3-8b, qwen1.5-32b with
qkv bias), the early-fusion VLM chameleon-34b (qk-norm; its VQ image
tokenizer is a stub in both packages), MoE (grok-1-314b, and
deepseek-v2-236b with MLA), SSM (falcon-mamba-7b), hybrid
(recurrentgemma-2b) and audio (musicgen-large, four codebooks; its codec
is a stub in both packages).  ``paper_mnist`` (alias ``paper-mnist``) is
the paper's own experiment, an `AsyncFLConfig`.  An unknown id raises
`KeyError`.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "grok_1_314b", "qwen1_5_32b", "chameleon_34b", "falcon_mamba_7b",
    "granite_3_8b", "musicgen_large", "recurrentgemma_2b",
    "deepseek_v2_236b", "gemma_7b", "gemma_2b",
]
# the paper's experiment, not an architecture (as in the JAX registry)
PAPER_ID = "paper_mnist"


def _module(arch_id: str):
    name = arch_id.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS and name != PAPER_ID:
        raise KeyError(f"unknown architecture {arch_id!r}; the port has "
                       f"{[i.replace('_', '-') for i in ARCH_IDS]}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE
