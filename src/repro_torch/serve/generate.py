"""Batched serving: prefill + greedy/temperature decode loop.

Ported from ``src/repro/serve/generate.py``.  PyTorch runs eagerly, so
``make_serve_step`` is a plain function (the reference jits it).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import decode_step, init_cache


def make_serve_step(cfg):
    """The single-step serving function ``step(params, cache, tokens,
    cache_len) -> (logits, cache)``."""
    def step(params, cache, tokens, cache_len):
        return decode_step(cfg, params, cache, tokens, cache_len)
    return step


def next_inputs(cfg, tok):
    """The next step's input for the sampled ids ``tok`` (B,): the ids
    (B, 1), or for an embedding-stub arch the embedded token fed back,
    ``jax.nn.one_hot(tok, d_model)``'s row (B, 1, d): one-hot below
    ``d_model``, all zeros at or above it, in the model's dtype."""
    if cfg.input_mode == "tokens":
        return tok[:, None]
    rows = torch.arange(cfg.d_model, device=tok.device)
    return (tok[:, None, None] == rows).to(getattr(torch, cfg.dtype))


def _sample(last, temperature, generator):
    """Gumbel-max draw from softmax(last / temperature), as
    ``jax.random.categorical`` draws, but with the generator's bits."""
    u = torch.rand(last.shape, generator=generator, device=last.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(last.float() / temperature - torch.log(-torch.log(u)),
                        dim=-1)


@torch.no_grad()
def generate(cfg, params, prompts, max_new_tokens: int, *,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             max_len: int | None = None, device="cuda",
             return_logits: bool = False):
    """prompts: (B, P) token ids (or (B, P, d) embeddings for stub archs),
    on ``device`` with ``params``.

    Returns (B, max_new_tokens) ids, and with ``return_logits`` also the
    (B, max_new_tokens, vocab) logits each id was drawn from.  Greedy when
    temperature == 0 (``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does); otherwise a Gumbel-max draw from ``generator``
    (default: seeded with 0 on ``device``), whose bits differ from
    ``jax.random.categorical``'s.  The lengths stay on the device, so a
    decode step makes no host sync.
    """
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape[0], prompts.shape[1]
    max_len = max_len or (P + max_new_tokens + 1)
    cache = init_cache(cfg, B, max_len, device=dev)
    step = make_serve_step(cfg)
    logits, cache = step(params, cache, prompts,
                         torch.zeros(B, dtype=torch.int32, device=dev))
    lens = torch.full((B,), P, dtype=torch.int32, device=dev)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out, seen = [], []
    last = logits[:, -1]
    for _ in range(max_new_tokens):
        if temperature > 0:
            tok = _sample(last, temperature, generator)
        else:
            tok = torch.argmax(last, dim=-1)
        out.append(tok)
        seen.append(last)
        logits, cache = step(params, cache, next_inputs(cfg, tok), lens)
        last = logits[:, 0]
        lens = lens + 1
    tokens = torch.stack(out, dim=1)
    return (tokens, torch.stack(seen, dim=1)) if return_logits else tokens
