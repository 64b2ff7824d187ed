# seed: unused — serving-stack arch config from the repo seed; no module of
# the port imports it (repro.analysis.deadcode quarantine).
"""MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Exact assigned dimensions live in ``repro_torch.models.registry.ARCHS``; this
module is the ``--arch granite-moe-1b-a400m`` entry point exposing the full config, the
reduced smoke config, and the applicable input shapes.
"""
from repro_torch.models import registry

ARCH = "granite-moe-1b-a400m"
CONFIG = registry.ARCHS[ARCH]
SMOKE = registry.reduced(CONFIG)
# (shape -> applies) long_500k needs sub-quadratic attention (DESIGN.md
# §Arch-applicability); decode applies to every assigned arch (all decode).
SHAPES = {
    "train_4k": True,
    "prefill_32k": True,
    "decode_32k": True,
    "long_500k": False,
}
