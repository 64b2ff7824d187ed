from .decode import generate, make_prefill, make_serve_step, sample_logits
from .scheduler import Request, ServeScheduler

__all__ = ["generate", "make_prefill", "make_serve_step", "sample_logits",
           "Request", "ServeScheduler"]
