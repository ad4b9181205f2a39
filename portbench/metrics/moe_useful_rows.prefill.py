"""The share of the rows the expert products compute that hold a kept
(token, expert) pair, in %: the program's ``moe.pairs_kept`` counter over
its ``moe.rows_computed``, both counted inside the traced window.  A pair
routed but not kept is dropped (``moe.pairs_routed`` minus kept)."""


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None:
        return None
    try:
        from repro_torch.models.common import counters
    except ImportError:
        return None
    got = counters()
    rows = got.get("moe.rows_computed")
    return 100.0 * got.get("moe.pairs_kept", 0) / rows if rows else None
