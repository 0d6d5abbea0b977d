"""Architecture registry: --arch <id> resolves here (a data-only copy of
``repro/configs``, with the port's ``ModelConfig``).

Each module exports CONFIG (the exact full-scale config from the brief) and
smoke() (a reduced same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

ARCHS = (
    "mamba2_1p3b",
    "h2o_danube_1p8b",
    "mistral_large_123b",
    "phi3_mini_3p8b",
    "stablelm_12b",
    "grok1_314b",
    "deepseek_v2_lite_16b",
    "internvl2_1b",
    "whisper_large_v3",
    "recurrentgemma_9b",
)

# brief ids -> module names
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "mistral-large-123b": "mistral_large_123b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "stablelm-12b": "stablelm_12b",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internvl2-1b": "internvl2_1b",
    "whisper-large-v3": "whisper_large_v3",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.CONFIG


def get_smoke(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.smoke()


def all_arch_ids() -> tuple[str, ...]:
    return tuple(ALIASES)
