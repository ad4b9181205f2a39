"""Batched serving loop, PyTorch port of :mod:`repro.launch.serve`: a
continuous-batching loop over a request queue, and the resident study
service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
        --requests 8 --max-new 32 [--device cpu]

As in the reference: a request queue; each slot is fed its prompt one token
a step (teacher-forced "prefill" through the decode path), then its own
greedy tokens, in lockstep with the other slots; finished slots are refilled
from the queue (continuous batching).  One cache and one ``len`` are shared
by all slots, so a refilled slot continues at the previous request's
position and attends to its cache entries (and, for the SSM and hybrid
archs, carries on from its predecessor's conv / SSM / RG-LRU states) —
the reference's behaviour, mirrored and not fixed (ROADMAP §C).

``--study`` switches to the resident *study* service
(:mod:`repro_torch.serve`): read a JSON file holding one study-request spec
(or a list of them), answer each through the hardened request loop —
retries, degradation, coalescing, crash-safe restart — and print one status
line per request and the totals, as the reference does::

    PYTHONPATH=src python -m repro_torch.launch.serve --study specs.json \\
        --cache-dir .serve_cache [--coalesce] [--adaptive] [--chaos-rate 0.1]

With ``--cache-dir`` the server journals admitted requests and keeps the
warm manifest there, so a re-launch replays every recorded dispatch once at
start (:mod:`repro_torch.serve.warm`: the libraries built and bound, each
kernel loaded) and answers repeat studies with no ``nvcc`` build and no new
library bind.  Last, the service prints one JSON line: the counts, the warm
replay and the builds and binds of this process (the port's addition).
``--device`` (default: the CUDA card) is the port's addition too; the
reference runs where JAX does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

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


def serve_study(args) -> list:
    """The resident study service: answer the request specs in
    ``args.study`` (a JSON file holding one spec dict or a list of them)
    through the hardened loop on ``args.device`` (``None``: the CUDA card),
    restarting from the warm manifest if the worker crashes.  Returns the
    terminal responses in rid order."""
    from repro_torch.kernels import _build
    from repro_torch.serve import (ChaosConfig, ChaosMonkey, ServeConfig,
                                   StudyServer, restart_server)

    specs = json.loads(pathlib.Path(args.study).read_text())
    if isinstance(specs, dict):
        specs = [specs]
    cfg = ServeConfig(default_deadline_s=args.deadline_s,
                      max_queue=args.max_queue, cache_dir=args.cache_dir,
                      seed=args.seed,
                      coalesce=args.coalesce or args.adaptive,
                      adaptive=args.adaptive,
                      device=getattr(args, "device", None))
    chaos = None
    if args.chaos_rate > 0:
        chaos = ChaosMonkey(ChaosConfig(seed=args.seed,
                                        fault_rate=args.chaos_rate))
    builds_at_start = _build.build_counts()
    server = StudyServer(cfg, chaos=chaos)
    warmed = {"entries": server.stats["warmed_entries"],
              "wall_s": server.warm.warm_wall_s if server.warm else 0.0,
              "builds": _build.build_counts()}
    if chaos is not None:
        chaos.clock = server.clock
    final = {}
    for spec in specs:
        out = server.submit(spec)
        if not isinstance(out, int):
            final[out.rid] = out
    for r in server.drain():
        final[r.rid] = r
    restarts = 0
    while server.crashed:
        print("worker crashed — restarting from the warm manifest")
        restarts += 1
        server, replayed = restart_server(cfg, chaos=chaos)
        for r in [*replayed, *server.drain()]:
            final[r.rid] = r
    for rid in sorted(final):
        r = final[rid]
        extra = f" ({r.error})" if r.error else ""
        print(f"req {rid}: {r.status} engine={r.engine} "
              f"attempts={r.attempts} {r.latency_s * 1e3:.0f} ms{extra}")
    counts: dict[str, int] = {}
    for r in final.values():
        counts[r.status] = counts.get(r.status, 0) + 1
    print(f"served {len(final)} requests: {counts}")
    if cfg.adaptive:
        t = server.telemetry.summary()
        print(f"policy: formation_holds={t['formation_holds']} "
              f"decisions={t['decisions']}")
    print(json.dumps({"serve_study": {
        "device": str(server.device), "requests": len(final), "statuses": counts,
        "restarts": restarts, "warmed_entries": warmed["entries"],
        "warm_wall_s": warmed["wall_s"],
        "first_latency_s": final[min(final)].latency_s if final else None,
        "builds_binds": {"at_start": builds_at_start, "after_warm": warmed["builds"],
                         "at_end": _build.build_counts()}}}))
    return [final[rid] for rid in sorted(final)]


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
                         "of running the token-serving loop")
    ap.add_argument("--cache-dir", default=None,
                    help="journal + warm manifest directory (enables "
                         "crash-safe restart and the warm replay at start)")
    ap.add_argument("--deadline-s", type=float, default=300.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help="inject this fraction of chaos faults (testing)")
    ap.add_argument("--coalesce", action="store_true",
                    help="coalesce compatible queued studies into shared "
                         "blessed-width batched dispatches (bit-exact; "
                         "poison requests are bisected out and quarantined)")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive coalescing policy (implies --coalesce): "
                         "slack-aware formation window under light load, "
                         "slack-driven batch width, repeat-offender group "
                         "keys routed to the sequential engine")
    args = ap.parse_args()
    if args.study:
        serve_study(args)
        return
    served = serve(args)
    if len(served) != args.requests:
        raise SystemExit(f"served {len(served)} of {args.requests} requests")


if __name__ == "__main__":
    main()
