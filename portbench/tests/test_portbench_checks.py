"""What decides ``correct``, on the tiny cells: a sound run passes; the
control (the reference computed with fp8 products, in the program's place)
and each fault the cells can have, planted under the harness, come out as
not correct."""

import pytest
import torch

from portbench import calibrate as CAL
from portbench import harness as H
from portbench.reference import model as RM
from portbench.tests._tiny import CPU, cell, run


def prefill_fault(kind: str):
    """The program's prefill step with a fault planted where it produces
    its answer."""
    from repro_torch.launch.steps import make_prefill_step

    def factory(model):
        step = make_prefill_step(model)

        def faulty(params, batch):
            ids = batch["tokens"]
            if kind == "half_batch":
                kept = step(params, {"tokens": ids[: ids.shape[0] // 2]})
                return kept.mean(0, keepdim=True).expand(ids.shape[0], -1).clone()
            out = step(params, batch)
            if kind == "answers_swapped":
                return out.roll(1, dims=0)
            return out
        return faulty
    return factory


def prefill_control(model):
    """The reference with fp8 products, in the program's place."""
    cfg = {"tiny-dense": cell("dense.prefill").cfg, "tiny-moe": cell("moe.prefill").cfg}
    ref = {}

    def step(params, batch):
        name = model.cfg.name
        if name not in ref:
            ref[name] = RM.Reference(cfg[name], params, "fp8")
        return ref[name].last_logits(batch["tokens"])
    return step


@pytest.mark.parametrize("workload", ["dense.prefill", "moe.prefill", "dense.train"])
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-2:] == ["checks", "_log"]


@pytest.mark.parametrize("workload", ["dense.prefill", "moe.prefill"])
@pytest.mark.parametrize("fault", ["half_batch", "answers_swapped"])
def test_prefill_fault_is_not_correct(workload, fault):
    out = run(workload, step_factory=prefill_fault(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["dense.prefill", "moe.prefill"])
def test_prefill_control_is_not_correct(workload):
    sound = run(workload)["checks"]
    out = run(workload, step_factory=prefill_control)
    assert not out["correct"]
    for name, c in out["checks"].items():
        assert c["value"] > 3 * sound[name]["value"] and c["value"] > c["limit"]


def state_unchanged(model, ocfg):
    """A training step that computes the loss and returns the state as it
    was."""
    def step(params, state, batch):
        with torch.no_grad():
            loss = model.loss(params, batch)
        return {"loss": loss, "grad_norm": torch.ones(()), "lr": torch.zeros(())}
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_rows", "leaf_unmoved"])
def test_train_fault_is_not_correct(fault):
    from repro_torch.launch.steps import make_train_step

    factory = {"state_unchanged": state_unchanged,
               "half_rows": CAL.half_rows(make_train_step),
               "leaf_unmoved": CAL.one_leaf_unmoved(make_train_step)}[fault]
    out = run("dense.train", step_factory=factory)
    assert not out["correct"], out["checks"]


def test_train_control_fails_a_limit():
    c = cell("dense.train")
    params, state, step, pool, prog = H.train_program(c, 1, CPU)
    rows = H.checked_rows(c, pool)
    ref = H.train_reference(c, 1, rows, CPU)
    control = H.train_reference(c, 1, rows, CPU, "fp8")
    sound, ctl = H.compare_train(prog, ref), H.compare_train(control, ref)
    assert all(sound[k] <= limit for k, limit in c.limits.items()), sound
    assert any(ctl[k] > limit for k, limit in c.limits.items()), ctl
