# seed: unused — serving-stack arch config from the repo seed; no module of
# the port imports it (repro.analysis.deadcode quarantine).
"""enc-dec audio LM, conv frontend stub [arXiv:2212.04356; unverified]

Exact assigned dimensions live in ``repro_torch.models.registry.ARCHS``; this
module is the ``--arch whisper-tiny`` entry point exposing the full config, the
reduced smoke config, and the applicable input shapes.
"""
from repro_torch.models import registry

ARCH = "whisper-tiny"
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
