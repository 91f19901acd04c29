"""Decode serving: prefill a batch of prompts, then step the decode loop
with the ring-buffer KV / recurrent-state cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --prompt-len 32 --gen 32 --batch 4 --device cpu

The flags are those of the JAX package's ``repro.launch.serve``, whose
``--smoke`` is always on (``store_true`` with ``default=True``), so the CLI
serves the smoke config; `generate` takes any config, the full-width one
included.  ``--device`` defaults to the card.  Parameters are drawn from
the seed; prompts are Zipf token ids drawn from it.  An audio model
(musicgen-large: K = 4 codebooks) takes (B, K, prompt_len) prompts and
samples each codebook, so its tokens are (B, K, gen).
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from ..configs import get_config, get_smoke_config
from ..core.fl_step import build_serve_step
from ..data.synthetic import token_stream
from ..device import resolve_device
from ..models.config import ArchConfig
from ..models.transformer import LM


class Generation(NamedTuple):
    """Prompts, tokens and logits gain a codebook dim K after the batch
    dim for an audio model."""
    model: LM
    prompts: torch.Tensor         # (B, prompt_len) int64
    tokens: torch.Tensor          # (B, gen) int64, the first from prefill
    prefill_logits: torch.Tensor  # (B, V) logits of the last prompt position
    decode_logits: List[torch.Tensor]   # gen - 1 steps of (B, V)
    prefill_s: float
    decode_s: float

    @property
    def decode_tokens_per_s(self) -> float:
        """Decoded positions per second over the batch (an audio model's K
        codebook tokens of a position count once)."""
        n = len(self.decode_logits) * self.tokens.shape[0]
        return n / max(self.decode_s, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample(logits, temperature: float, generator: torch.Generator):
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


@torch.inference_mode()
def generate(cfg: ArchConfig, batch: int = 4, prompt_len: int = 32,
             gen: int = 32, temperature: float = 1.0, seed: int = 0,
             device=None, *,
             on_phase: Optional[Callable[[str], None]] = None) -> Generation:
    """Prefill ``batch`` Zipf prompts of ``prompt_len`` tokens, then decode
    ``gen - 1`` steps: ``gen`` new tokens per prompt, the first from the
    prefill's logits (as the JAX package's serve loop does).  Greedy when
    ``temperature == 0``, else sampled from the port's generator.  An
    audio model's prompts are (batch, K, prompt_len), and each of its K
    codebooks is sampled.

    Parameters are drawn from ``seed`` on the device.  ``on_phase`` is
    called with "prefill", "decode" and "end" at the phase boundaries,
    after the device has finished the work before it (a caller reads
    counters there)."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    shape = (batch, prompt_len)
    if cfg.num_codebooks > 1:
        shape = (batch, cfg.num_codebooks, prompt_len)
    prompts = token_stream(g, math.prod(shape), cfg.vocab_size
                           ).reshape(shape).to(dev)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    phase = on_phase or (lambda name: None)

    _sync(dev)
    phase("prefill")
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache_len=prompt_len + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    phase("decode")

    step = build_serve_step(cfg)
    params = dict(model.named_parameters())
    tok = _sample(logits, temperature, sampler)
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(gen - 1):
        step_logits, cache = step(params, cache, tok, prompt_len + i)
        steps.append(step_logits)
        tok = _sample(step_logits, temperature, sampler)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    phase("end")
    return Generation(model, prompts, torch.stack(out, dim=-1), logits,
                      steps, prefill_s, decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    r = generate(cfg, args.batch, args.prompt_len, args.gen,
                 args.temperature, seed=0, device=args.device)
    print(f"prefill,{args.batch}x{args.prompt_len},{r.prefill_s:.2f}s")
    ntok = len(r.decode_logits) * args.batch
    print(f"decode,{ntok}_tokens,{r.decode_s:.2f}s,"
          f"{r.decode_tokens_per_s:.1f}tok/s")
    print("sample_ids:", r.tokens[0].reshape(-1)[:16].tolist())


if __name__ == "__main__":
    main()
