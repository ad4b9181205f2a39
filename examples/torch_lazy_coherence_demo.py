"""LazySync demo on the PyTorch port: the paper's coherence protocol
driving sparse embedding sync across 4 data-parallel groups, vs dense
all-reduce (beyond-paper).  The counterpart of
``examples/lazy_coherence_demo.py``.

    PYTHONPATH=src python examples/torch_lazy_coherence_demo.py               # on the card
    PYTHONPATH=src python examples/torch_lazy_coherence_demo.py --device cpu  # plain PyTorch

The touched rows and gradients are the reference's ``jax.random`` draws,
bit for bit (:mod:`repro_torch.sim._jaxrandom`), so the conflict counts and
byte totals equal the reference demo's; the embedding table's initial
values come from a seeded ``torch.Generator`` (they move no count).
``--steps`` shortens the run (default 24).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sim import _jaxrandom as jr  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--steps", type=int, default=24)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sync steps; returns what it prints: each step's conflict
    rows, commit flag and lazy / dense bytes, and the two byte totals."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mcfg = get_smoke_config("qwen3_4b")
    cfg = LazySyncConfig(num_groups=4, commit_interval=8, max_reconcile_rows=128)
    emb = LazyEmbed(mcfg, cfg)
    params = emb.init(torch.Generator(device=dev).manual_seed(0))
    state = init_state(cfg, mcfg.vocab, device=dev)

    key = jr.key(1)
    tot_lazy = tot_dense = 0.0
    steps = []
    groups = torch.arange(cfg.num_groups, device=dev)[:, None]
    for step in range(args.steps):
        key, k1, k2 = jr.split(key, 3)
        # each group touches a sparse, partly-overlapping row set
        touched = jr.randint(k1, (cfg.num_groups, 48), 0, mcfg.vocab // 4)
        g = jr.normal(k2, touched.shape + (mcfg.d_model,)) * 0.05
        touched = torch.from_numpy(touched).to(dev)
        grads = torch.zeros((cfg.num_groups, mcfg.vocab, mcfg.d_model), device=dev)
        grads.index_put_((groups, touched.to(torch.int64)), torch.from_numpy(g).to(dev),
                         accumulate=True)
        params, state, m = emb.sync_step(params, state, touched, grads)
        row = {"conflicts": int(m["lazy_conflict_rows"]), "commit": bool(m["lazy_commit"]),
               "lazy_bytes": float(m["lazy_bytes"]), "dense_bytes": float(m["dense_bytes"])}
        steps.append(row)
        tot_lazy += row["lazy_bytes"]
        tot_dense += row["dense_bytes"]
        if step % 8 == 7:
            print(f"step {step}: conflicts={row['conflicts']} commit={row['commit']} "
                  f"lazy={row['lazy_bytes'] / 1e3:.1f}KB dense={row['dense_bytes'] / 1e3:.1f}KB")
    print(f"\ntotal coherence bytes: LazySync {tot_lazy / 1e6:.2f}MB vs "
          f"dense {tot_dense / 1e6:.2f}MB  ({1 - tot_lazy / tot_dense:.1%} saved)")
    return {"steps": steps, "lazy_bytes": tot_lazy, "dense_bytes": tot_dense}


if __name__ == "__main__":
    main()
