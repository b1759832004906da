from .generate import generate, make_serve_step, next_inputs

__all__ = ["generate", "make_serve_step", "next_inputs"]
