"""End-to-end training driver, PyTorch port of :mod:`repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
        --steps 50 --batch 8 --seq 128 [--ckpt-dir /tmp/ckpt] [--fail-at 20] \\
        [--device cpu]

The train step runs eagerly on ``--device`` (default: the CUDA card; the
port's addition, the reference runs where JAX does).  ``--fail-at``
injects a simulated failure to exercise checkpoint/restart: the run
restarts in-process from the latest checkpoint.  Parameters come from a
seeded ``torch.Generator`` on the device (the reference's distributions,
not its ``jax.random`` numbers).  The train step updates the parameters
and the optimizer state in place (:func:`repro_torch.launch.steps
.make_train_step`).  Batches and frontend embeddings
are the reference's, bit for bit (``data.pipeline.host_batch``,
``models.frontends.synth_embeddings``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.frontends import synth_embeddings
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, StragglerDetector
from repro_torch.sim import _jaxrandom


def build(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5),
                                moment_dtype=cfg.opt_dtype)
    train_step = steps_lib.make_train_step(model, opt_cfg)
    return cfg, model, opt_cfg, train_step


def run(args) -> dict:
    dev = resolve_device(getattr(args, "device", None))
    cfg, model, opt_cfg, train_step = build(args)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt_state = adamw.init(params, opt_cfg)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start, restored_step = 0, None
    if ckpt and ckpt.latest_step() is not None:
        start = restored_step = ckpt.latest_step()
        state = ckpt.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"restored checkpoint at step {start}")

    hb = HeartbeatMonitor()
    stragglers = StragglerDetector()
    losses = []
    for step in range(start, args.steps):
        if args.fail_at is not None and step == args.fail_at and start == 0:
            print(f"!! injected failure at step {step} — restarting from ckpt")
            # a real cluster would crash here; we restart in-process
            args2 = argparse.Namespace(**vars(args))
            args2.fail_at = None
            return run(args2)

        batch = host_batch(data_cfg, step, dev)
        if cfg.encoder_layers > 0:
            batch["frames"] = synth_embeddings(cfg, data_cfg.host_batch,
                                               _jaxrandom.key(step), args.seq, dev)
        elif cfg.frontend is not None:
            batch["prefix_embeds"] = synth_embeddings(
                cfg, data_cfg.host_batch, _jaxrandom.key(step), args.seq, dev)

        t0 = time.time()
        metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        hb.beat(0, step)
        stragglers.observe(0, time.time() - t0)

        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time()-t0:.2f}s)")
        if ckpt and step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()
    return {"first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "restored_step": restored_step}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args()
    out = run(args)
    print(f"loss: {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
    assert out["last_loss"] < out["first_loss"], "training did not reduce loss"


if __name__ == "__main__":
    main()
