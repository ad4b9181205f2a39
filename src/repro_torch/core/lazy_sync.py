"""LazySync, PyTorch port of :mod:`repro.core.lazy_sync`: the paper's
speculative-signature coherence protocol applied to sparse embedding-table
synchronization in data-parallel training.

Mapping from LazyPIM (as in the reference):

    PIM core            -> data-parallel replica group
    cache line          -> embedding row
    speculative writes  -> local (unsynced) row updates per group
    PIMWriteSet         -> per-group Bloom signature of touched row ids
    conflict detection  -> signature membership across groups
    flush + merge       -> exact reconciliation of conflicting rows only
    partial commit      -> full table sync every K steps
    lock after 3 RBs    -> rows with persistent conflicts pinned to eager sync

Params are a dict ``{table: (G, V, d), base: (V, d)}``; updates are linear
(SGD on the embedding), so reconciliation is exact:
``new_row = base + sum_g (table_g[row] - base[row])``.

**Kernels.**  On CUDA tensors the protocol runs on the port's hand-written
kernels: the H3 hash of the touched ids (``h3_hash``), the fused conflict
detector on packed signatures (``bloom_detect_conflicts``, which ports
``bloom_detect_conflicts_pallas``) and the row merge (``lazy_merge``,
which ports ``lazy_merge_pallas``); on CPU tensors their plain versions.
The tensors' device picks the route; ``LazySyncConfig.use_kernel`` is kept
for field parity with the reference and selects nothing.  :meth:`commit`
is the merge with every row valid, so it too runs through ``lazy_merge``,
over all V rows.

**Where the port differs from the reference, on purpose.**

* The (G, V, d) table is always materialized (``init``, ``commit``): the
  reference's ``broadcast_to`` would be a torch ``expand`` view whose G
  replicas share storage.  Every method returns new tensors and never
  writes its inputs, as the reference's pure functions do.
* :meth:`reconcile` scatters only the valid rows.  The reference maps
  every invalid budget slot to row 0 and scatters with duplicate indices,
  so when row 0 itself conflicts its merge can be overwritten by a stale
  slot's write (``tests/test_torch_lazy_sync.py::test_row0_merged_where_reference_leaves_it_stale``);
  everywhere else the two agree.
* Touched ids outside ``[0, vocab)`` raise a ``ValueError``, where the
  reference's scatters drop them and its gathers clamp them.
* ``state["step"]`` is a CPU tensor (host-side step counter), so deciding
  whether the commit fires costs no device synchronization; its values
  are the reference's.
* Budget selection uses a stable descending sort, which breaks the many
  score ties by lowest index exactly as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    hash_positions,
    pack_words,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.bloom.ops import bloom_detect_conflicts
from repro_torch.kernels.lazy_merge.ops import lazy_merge
from repro_torch.models import common as C


@dataclasses.dataclass(frozen=True)
class LazySyncConfig:
    num_groups: int = 4
    sig_bits: int = 2048
    num_segments: int = 4
    commit_interval: int = 16          # K: partial-commit period (steps)
    max_reconcile_rows: int = 1024     # per-step exact-reconcile budget
    pin_streak: int = 3                # paper's lock-after-3-rollbacks rule
    embed_lr: float = 0.05
    use_kernel: bool = False           # field parity only: the device routes


def init_state(cfg: LazySyncConfig, vocab: int, device=None) -> dict:
    """``{step: 0-d int32 on the CPU, streak: (vocab,) int8 on device}``;
    ``device=None`` means the CUDA card, as for every entry point of the
    port (:func:`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "streak": torch.zeros((vocab,), dtype=torch.int8, device=dev),
    }


def params_from_jax(params: dict, device) -> dict:
    """Carry a reference ``{table, base}`` (numpy arrays, e.g.
    ``{k: np.asarray(v)}`` of a ``repro`` LazyEmbed's params) to torch on
    ``device``.  bfloat16 arrays (``ml_dtypes``) cross as their 16-bit
    patterns and are viewed as ``torch.bfloat16``; float32 crosses as is."""
    out = {}
    for k, a in params.items():
        try:
            out[k] = C.tensor_from_numpy(a, device)
        except TypeError as e:
            raise TypeError(f"params_from_jax: {k}: {e}") from None
    return out


@dataclasses.dataclass(frozen=True)
class LazyEmbed:
    """Grouped speculative embedding: params {table: (G,V,d), base: (V,d)}."""

    model_cfg: C.ModelConfig
    cfg: LazySyncConfig

    def param_specs(self) -> dict:
        g = self.cfg.num_groups
        v, d = self.model_cfg.vocab, self.model_cfg.d_model
        dt = self.model_cfg.param_dtype
        return {
            "table": C.ParamSpec((g, v, d), ("batch", "vocab", "embed"), dt,
                                 "small_normal"),
            "base": C.ParamSpec((v, d), ("vocab", "embed"), dt, "small_normal"),
        }

    def init(self, generator: torch.Generator) -> dict:
        """``base ~ N(0, 0.02)`` drawn from ``generator`` on its device, and
        G materialized copies of it as the table.  The numbers differ from
        the reference's ``jax.random`` draw; :func:`params_from_jax` carries
        the reference's params across where a test needs the same ones."""
        v, d = self.model_cfg.vocab, self.model_cfg.d_model
        base = (torch.randn((v, d), generator=generator, dtype=torch.float32,
                            device=generator.device) * 0.02).to(
            self.model_cfg.param_dtype)
        return {"table": self._replicate(base), "base": base}

    def _replicate(self, row_block: torch.Tensor) -> torch.Tensor:
        """(V, d) -> materialized (G, V, d): G copies, not an expand view."""
        g = self.cfg.num_groups
        return row_block.unsqueeze(0).expand((g,) + row_block.shape).contiguous()

    # ---- forward ------------------------------------------------------------

    def lookup(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (G, B/G, S) -> (G, B/G, S, d): each group reads its own
        speculative replica (= PIM core reading its own speculative cache)."""
        table = params["table"]
        scale = torch.tensor(self.model_cfg.d_model ** 0.5,
                             dtype=self.model_cfg.param_dtype, device=table.device)
        g = torch.arange(table.shape[0], device=table.device)
        return table[g.view(-1, *([1] * (tokens.dim() - 1))), tokens] * scale

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (G, B/G, S, d) -> per-group tied-embedding logits (G, B/G, S, V)."""
        return torch.einsum("gbsd,gvd->gbsv", x, params["table"])

    # ---- speculative update + coherence --------------------------------------

    def apply_grads(self, params: dict, grads_table: torch.Tensor) -> dict:
        """Local speculative SGD on each group's replica (no cross-group
        communication — the speculation step)."""
        new = params["table"].to(torch.float32) - \
            grads_table.to(torch.float32) * self.cfg.embed_lr
        return {**params, "table": new.to(params["table"].dtype)}

    @functools.cached_property
    def spec(self) -> SignatureSpec:
        """Signature geometry, built once per LazyEmbed."""
        return SignatureSpec(self.cfg.sig_bits, self.cfg.num_segments)

    def check_touched(self, touched: torch.Tensor) -> None:
        """Raise a ``ValueError`` for touched ids outside ``[0, vocab)``
        (one device synchronization)."""
        if touched.numel() == 0:
            return
        lo, hi = torch.aminmax(touched.reshape(-1))
        lo, hi = int(lo), int(hi)
        vocab = self.model_cfg.vocab
        if lo < 0 or hi >= vocab:
            raise ValueError(f"touched ids must lie in [0, {vocab}), got "
                             f"min {lo}, max {hi}")

    def hash_touched(self, touched: torch.Tensor) -> torch.Tensor:
        """Byte-sliced H3 positions for all touched ids: (G*T, M) int32
        (the ``h3_hash`` kernel on CUDA)."""
        return hash_positions(self.spec, touched.reshape(-1))

    def signatures(self, touched: torch.Tensor) -> torch.Tensor:
        """Per-group Bloom signatures of touched rows: (G, T) ids ->
        (G, sig_bits) bool."""
        g = touched.shape[0]
        pos_g = self.hash_touched(touched).reshape(g, -1).to(torch.int64)
        sigs = torch.zeros((g, self.cfg.sig_bits), dtype=torch.bool,
                           device=touched.device)
        sigs.scatter_(1, pos_g, True)
        return sigs

    def detect_conflicts(self, touched: torch.Tensor, sigs: torch.Tensor,
                         force: torch.Tensor | None = None,
                         with_mask: bool = False):
        """Row ids touched by >= 2 groups (with the signatures' real FPs).

        The signatures are packed and every touched id is re-hashed and
        tested against all G of them by ``bloom_detect_conflicts`` (the
        kernel on CUDA, its plain version on the CPU), so the reference's
        precomputed-positions argument ``pos`` has no counterpart.
        ``force`` (G*T,) bool marks entries that must be reconciled
        regardless (the §5.5 pin rule).  Returns (row_ids (R,), valid (R,))
        with R = min(max_reconcile_rows, G*T); with ``with_mask=True`` also
        the per-entry conflict mask (G*T,) before budget truncation.
        """
        self.check_touched(touched)
        flat = touched.reshape(-1)
        hit_groups = bloom_detect_conflicts(self.spec, pack_words(sigs), flat)
        conflict = hit_groups >= 2
        if force is not None:
            conflict = conflict | force.reshape(-1)
        # Budget selection: only the FIRST occurrence of each row scores, so
        # a hot row's duplicate entries take one slot; forced (pinned) rows
        # outrank ordinary conflicts.
        n = flat.shape[0]
        dev = flat.device
        flat64 = flat.to(torch.int64)
        order = torch.arange(n, dtype=torch.int64, device=dev)
        first = torch.full((self.model_cfg.vocab,), n, dtype=torch.int64,
                           device=dev)
        first.scatter_reduce_(0, flat64, order, "amin", include_self=True)
        is_first = first[flat64] == order
        score = torch.where(is_first & conflict, 1.0, 0.0)
        if force is not None:
            score = torch.where(is_first & force.reshape(-1), 2.0, score)
        # jax.lax.top_k breaks ties by lowest index: a stable descending sort
        k = min(self.cfg.max_reconcile_rows, n)
        idx = torch.sort(score, descending=True, stable=True).indices[:k]
        rows = flat[idx]
        valid = score[idx] > 0  # unique conflicting/forced rows only
        if with_mask:
            return rows, valid, conflict
        return rows, valid

    def reconcile(self, params: dict, rows: torch.Tensor,
                  valid: torch.Tensor) -> dict:
        """Exact merge of the valid budget rows (the WAW dirty-bit-mask
        merge): new = base + sum_g (table_g - base) through ``lazy_merge``,
        written to all replicas and to base.  Only valid rows are written
        (see the module docstring for the reference's row-0 behaviour)."""
        return self._reconcile_into(params["table"].clone(), params["base"],
                                    rows, valid)

    @staticmethod
    def _reconcile_into(table: torch.Tensor, base: torch.Tensor,
                        rows: torch.Tensor, valid: torch.Tensor) -> dict:
        """:meth:`reconcile` that writes the merged rows into ``table`` in
        place (the caller owns it) and into a new base."""
        safe = torch.where(valid, rows, 0).to(torch.int64)
        merged = lazy_merge(table[:, safe, :], base[safe, :], valid)  # (R, d) f32
        keep = torch.nonzero(valid).squeeze(1)
        idx = safe[keep]
        vals = merged[keep].to(base.dtype)
        table[:, idx, :] = vals.to(table.dtype)
        return {"table": table, "base": base.index_put((idx,), vals)}

    def commit(self, params: dict) -> dict:
        """Partial commit (every K steps): full exact sync of all rows, the
        ``lazy_merge`` of every row with all rows valid."""
        table, base = params["table"], params["base"]
        valid = torch.ones((base.shape[0],), dtype=torch.bool, device=base.device)
        new = lazy_merge(table, base, valid).to(base.dtype)
        return {"table": self._replicate(new), "base": new}

    # ---- one protocol step -----------------------------------------------------

    def sync_step(self, params: dict, state: dict, touched: torch.Tensor,
                  grads_table: torch.Tensor):
        """Speculative apply -> signature exchange -> conflict reconcile ->
        periodic commit.  Returns (params, state, metrics)."""
        cfg = self.cfg
        self.check_touched(touched)
        params = self.apply_grads(params, grads_table)
        sigs = self.signatures(touched)

        # pin rule (paper §5.5 lock-after-3): rows whose conflict streak
        # reached pin_streak are forced into the reconcile set.
        streak = state["streak"]
        flat = touched.reshape(-1).to(torch.int64)
        pinned_mask = streak[flat] >= cfg.pin_streak  # (G*T,)
        rows, valid, conflict_mask = self.detect_conflicts(
            touched, sigs, force=pinned_mask, with_mask=True)

        # streak accounting from the full pre-budget conflict mask: each
        # unique conflicting row gains exactly 1 (saturating at 127); rows
        # touched without conflicting reset to 0; untouched rows keep theirs.
        vocab = streak.shape[0]
        mark = self._row_mark(torch.where(conflict_mask, flat, vocab), vocab)
        touched_mark = self._row_mark(flat, vocab)
        bumped = torch.clamp(streak.to(torch.int32) + 1, max=127).to(torch.int8)
        streak = torch.where(mark, bumped,
                             torch.where(touched_mark, torch.zeros_like(streak),
                                         streak))

        # apply_grads made a fresh table: merge into it without a copy
        params = self._reconcile_into(params["table"], params["base"], rows,
                                      valid)

        step = state["step"] + 1
        do_commit = int(step) % cfg.commit_interval == 0  # host-side counter
        if do_commit:
            params = self.commit(params)
            streak = torch.zeros_like(streak)

        # unique pinned rows (not pinned entries)
        pin_mark = self._row_mark(torch.where(pinned_mask, flat, vocab), vocab)

        n_conflicts = valid.sum(dtype=torch.int64)
        dense = self.model_cfg.vocab * self.model_cfg.d_model * 4
        metrics = {
            "lazy_conflict_rows": n_conflicts,
            "lazy_pinned": pin_mark.sum(dtype=torch.int64),
            "lazy_commit": do_commit,
            # comm accounting (bytes): signatures + reconciled rows vs dense
            "lazy_bytes": (cfg.num_groups * cfg.sig_bits // 8
                           + n_conflicts * self.model_cfg.d_model * 4
                           + (dense if do_commit else 0)),
            "dense_bytes": dense,
        }
        return params, {"step": step, "streak": streak}, metrics

    @staticmethod
    def _row_mark(ids: torch.Tensor, vocab: int) -> torch.Tensor:
        """(vocab,) bool: True at every id < vocab (``vocab`` is the drop
        sentinel)."""
        mark = torch.zeros((vocab + 1,), dtype=torch.bool, device=ids.device)
        mark[ids] = True
        return mark[:vocab]
