"""Batched serving loop, PyTorch port of the token-serving half of
:mod:`repro.launch.serve`: a continuous-batching loop over a request queue.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
        --requests 8 --max-new 32 [--device cpu]

As in the reference: a request queue; each slot is fed its prompt one token
a step (teacher-forced "prefill" through the decode path), then its own
greedy tokens, in lockstep with the other slots; finished slots are refilled
from the queue (continuous batching).  One cache and one ``len`` are shared
by all slots, so a refilled slot continues at the previous request's
position and attends to its cache entries — the reference's behaviour,
mirrored and not fixed (ROADMAP §C).

``--study`` (the resident study service, :mod:`repro.serve`) comes with the
serve slice of the port (ROADMAP A10) and raises, as does any of the
options that only modify it (``--cache-dir``, ``--deadline-s``,
``--max-queue``, ``--chaos-rate``, ``--coalesce``, ``--adaptive``) set
away from its default, so that none is taken for having had an effect.  ``--device`` (default:
the CUDA card) is the port's addition; the reference runs where JAX does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

SERVE_SLICE = ("the resident study service (--study, repro.serve) comes with "
               "the serve slice of the port (ROADMAP A10)")
# options of the study service, with their defaults (main() parses them for
# flag parity with the reference; serve() refuses any other value)
STUDY_OPTIONS = {"study": None, "cache_dir": None, "deadline_s": 300.0, "max_queue": 64,
                 "chaos_rate": 0.0, "coalesce": False, "adaptive": False}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def make_requests(cfg, n: int, seed: int = 0, max_new: int = 32):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new=max_new))
    return reqs


def serve(args, params: dict | None = None) -> list[Request]:
    """Serve ``args.requests`` requests; returns them in the order they
    finished.  ``params`` (a tree of tensors on the device, e.g. from
    ``params_from_jax``) replaces the loop's own seeded init, which draws
    from ``torch.Generator(device).manual_seed(0)`` where the reference
    draws from ``jax.random.key(0)``."""
    set_ = ["--" + k.replace("_", "-") for k, d in STUDY_OPTIONS.items()
            if getattr(args, k, d) != d]
    if set_:
        raise ValueError(f"{', '.join(set_)}: {SERVE_SLICE}")
    dev = resolve_device(getattr(args, "device", None))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_layers != 0 or cfg.frontend is not None:
        raise ValueError("the serve loop targets decoder-only text archs")
    model = Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))

    queue = make_requests(cfg, args.requests, args.seed, args.max_new)
    batch = args.batch
    max_len = args.max_len

    # continuous batching state
    slots: list[Request | None] = [None] * batch
    cache = model.init_cache(batch, max_len, dev)
    # one shared cache: per-slot "position" handled by feeding tokens in
    # lockstep; empty slots decode a pad token and are ignored.
    t0 = time.perf_counter()
    served = []
    pending = list(queue)

    def refill():
        for s in range(batch):
            if slots[s] is None and pending:
                slots[s] = pending.pop(0)

    refill()
    steps = 0
    while any(s is not None for s in slots):
        feed = np.zeros((batch, 1), np.int64)
        for s, req in enumerate(slots):
            if req is None:
                continue
            consumed = len(req.out)
            if consumed < len(req.prompt):
                feed[s, 0] = req.prompt[consumed]
            elif req.out:
                feed[s, 0] = req.out[-1] % cfg.vocab_size
        logits, cache = model.decode(params, torch.from_numpy(feed).to(dev), cache)
        steps += 1
        nxt = torch.argmax(logits[:, 0, : cfg.vocab_size], dim=-1).cpu().numpy()
        for s, req in enumerate(slots):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            new_tokens = len(req.out) - len(req.prompt)
            if new_tokens >= req.max_new or steps >= max_len - 1:
                req.done = True
                served.append(req)
                slots[s] = None
        refill()
        if steps >= max_len - 1:
            break

    dt = time.perf_counter() - t0
    total_toks = sum(len(r.out) for r in served)
    print(f"served {len(served)} requests, {total_toks} tokens, "
          f"{steps} batched steps in {dt:.1f}s "
          f"({total_toks/max(dt,1e-9):.1f} tok/s)")
    return served


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--study", default=None, metavar="SPECS_JSON",
                    help="serve study requests from this JSON file instead "
                         "of running the token-serving loop (not ported: "
                         "raises)")
    ap.add_argument("--cache-dir", default=None,
                    help="journal + persistent compile cache + warm "
                         "manifest directory (with --study)")
    ap.add_argument("--deadline-s", type=float, default=300.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help="inject this fraction of chaos faults (with --study)")
    ap.add_argument("--coalesce", action="store_true",
                    help="coalesce compatible queued studies (with --study)")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive coalescing policy (with --study)")
    args = ap.parse_args()
    served = serve(args)
    if len(served) != args.requests:
        raise SystemExit(f"served {len(served)} of {args.requests} requests")


if __name__ == "__main__":
    main()
