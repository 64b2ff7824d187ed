"""The LM families (dense so far): ``registry``, ``layers``, ``lm``."""
