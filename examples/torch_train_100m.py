"""End-to-end training driver on the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps on the synthetic pipeline, with
checkpointing and an injected failure + restart.  The counterpart of
``examples/train_100m.py``; the train step runs eagerly (the reference
wraps it in ``jax.jit``).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]               # on the card
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 6 \\
        --batch 1 --seq 32 --layers 1                                           # plain PyTorch

``--layers`` cuts the depth (default 12); the widths stay.
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def model_100m(num_layers: int = 12) -> ModelConfig:
    # ~100M params: 12L x d512 x ff2048, 16k vocab, qwen3-style qk-norm GQA
    return ModelConfig(
        name="qwen3-100m", family="dense", num_layers=num_layers, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=16_384, qk_norm=True, remat=False)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train through ``launch.train.run`` with the 100M config, failing at
    half the steps and restarting from the last checkpoint; returns
    ``run``'s record (first and last loss, every loss, the restored step)
    with the parameter count.  Run as a script it then fails unless the
    loss fell, as the reference example asserts (at a few steps of a cut
    model it need not: the task is learnt in context, slowly)."""
    args_in = parse_args(argv)
    cfg = model_100m(args_in.layers)
    model = Model(cfg)
    print(f"params: {model.param_count() / 1e6:.1f}M")

    # route through the production train loop with a custom config
    orig_build = T.build

    def build_override(args):
        opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=10)
        return cfg, model, opt_cfg, T.steps_lib.make_train_step(model, opt_cfg)

    T.build = build_override
    try:
        with tempfile.TemporaryDirectory() as d:
            args = argparse.Namespace(
                arch="qwen3-4b", smoke=True, steps=args_in.steps,
                batch=args_in.batch, seq=args_in.seq, lr=3e-3, seed=0,
                log_every=20, ckpt_dir=d, ckpt_every=50,
                fail_at=args_in.steps // 2, device=args_in.device)
            out = T.run(args)
    finally:
        T.build = orig_build
    print(f"loss: {out['first_loss']:.3f} -> {out['last_loss']:.3f}")
    return dict(out, params=model.param_count())


if __name__ == "__main__":
    record = main()
    if not record["last_loss"] < record["first_loss"]:
        sys.exit("training did not reduce the loss")
