# seed: unused — serving-stack arch config from the repo seed; no module of
# the port imports it (repro.analysis.deadcode quarantine).
"""Per-architecture config modules (``--arch <id>``).

Each module exports CONFIG (exact published dims), SMOKE (reduced), and
SHAPES (which assigned input shapes apply).  ``get(arch)`` resolves by id.
"""
import importlib

ARCH_IDS = [
    "starcoder2-3b", "starcoder2-15b", "deepseek-7b", "h2o-danube-3-4b",
    "pixtral-12b", "deepseek-v3-671b", "granite-moe-1b-a400m", "xlstm-1.3b",
    "whisper-tiny", "zamba2-1.2b",
]


def get(arch: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod
